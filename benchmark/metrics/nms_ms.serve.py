"""Host ms a scene of the program's span ``sgc.decode.nms``
(``det_head.decode_bboxes`` around the aligned 3D NMS), read from the
program's recorder over the profiled sub-window (``program_trace``)."""
from benchmark.program_trace import span_ms


def read(trace):
    return span_ms(trace, "sgc.detect", "sgc.decode.nms", "host_ms")
