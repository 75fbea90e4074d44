"""Rank 0's device ms a step of the program's span ``sgc.step.exchange``
(the data-parallel step's all-reduces after the backward: gradients, loss
terms, BN statistics; it includes waiting for the other ranks), read from
rank 0's recorder over the profiled sub-window (``program_trace``)."""
from benchmark.program_trace import span_ms


def read(trace):
    return span_ms(trace, "sgc.step", "sgc.step.exchange", "device_ms")
