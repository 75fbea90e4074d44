"""Device ms a step of the program's span ``sgc.step.forward`` (the step's
``scene_losses``: the train-mode forward and the loss dict), read from its
recorder over the profiled sub-window (``program_trace``)."""
from benchmark.program_trace import span_ms


def read(trace):
    return span_ms(trace, "sgc.step", "sgc.step.forward", "device_ms")
