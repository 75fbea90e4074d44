"""Percent of the query slots that the DFA3D kernels ran on which hold a
visible query: the program's counters ``lift.visible`` over ``lift.slots``
(``view_transformer.DeformCrossAttention._sample_dfa3d``, every level),
read from its recorder over the profiled sub-window (``program_trace``)."""
from benchmark.program_trace import counter_share


def read(trace):
    return counter_share(trace, "sgc.detect", "lift.visible", "lift.slots")
