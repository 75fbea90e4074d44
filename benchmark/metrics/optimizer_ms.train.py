"""Device ms a step of the program's span ``sgc.step.optimizer`` (the step's
``optimizer.step()``: the global-norm clip and AdamW), read from its
recorder over the profiled sub-window (``program_trace``)."""
from benchmark.program_trace import span_ms


def read(trace):
    return span_ms(trace, "sgc.step", "sgc.step.optimizer", "device_ms")
