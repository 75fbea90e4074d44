"""Device ms a step of the program's span ``sgc.step.backward`` (the step's
``zero_grad`` and backward through the kernels' backward passes), read from
its recorder over the profiled sub-window (``program_trace``)."""
from benchmark.program_trace import span_ms


def read(trace):
    return span_ms(trace, "sgc.step", "sgc.step.backward", "device_ms")
