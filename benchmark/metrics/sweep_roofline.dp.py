"""Share of their bound that the plane-sweep kernels K1 and K4 reach
(ops/sweep.py -> csrc/sweep_*.cu) in rank 0's data-parallel step."""
from benchmark.readers import roofline


def read(trace):
    return roofline(trace, "sweep")
