"""Boxes a scene that enter the NMS: the program's counter
``decode.nms_in`` (``det_head.decode_bboxes``, after the score threshold),
read from its recorder over the profiled sub-window (``program_trace``)."""
from benchmark.program_trace import counter


def read(trace):
    return counter(trace, "sgc.detect", "decode.nms_in")
