"""Device ms a scene of the program's span ``sgc.detect.upload``
(``infer.scene_inputs``: the scene's host arrays to the card), read from
the program's recorder over the profiled sub-window (``program_trace``)."""
from benchmark.program_trace import span_ms


def read(trace):
    return span_ms(trace, "sgc.detect", "sgc.detect.upload", "device_ms")
