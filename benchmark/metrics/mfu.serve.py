"""Model FLOPs utilization of the whole step: the reference's conv, matmul,
DFA3D and sweep FLOPs of a call over the window's time a call, against the
card's dense bf16 peak."""
from benchmark.readers import mfu


def read(trace):
    return mfu(trace)
