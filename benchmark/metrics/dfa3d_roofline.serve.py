"""Share of their bound that the DFA3D kernels reach (ops/dfa3d.py,
ops/dfa3d_windowed.py -> csrc/dfa3d_*.cu)."""
from benchmark.readers import roofline


def read(trace):
    return roofline(trace, "dfa3d")
