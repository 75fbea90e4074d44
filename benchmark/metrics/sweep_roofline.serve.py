"""Share of their bound that the plane-sweep kernels K1 and K4 reach
(ops/sweep.py -> csrc/sweep_*.cu)."""
from benchmark.readers import roofline


def read(trace):
    return roofline(trace, "sweep")
