"""Ops of the port: the hand-written Hopper kernels behind their wrappers,
their plain PyTorch versions, and host-side NMS."""
from ._cuda import LIBRARY, plain_ops
from .dfa3d import COUNTERS as DFA3D_COUNTERS
from .dfa3d import dfa3d_attend, dfa3d_attention_plain, msda_2d_attend
from .dfa3d_windowed import WIN_COUNTERS, dfa3d_attention_windowed
from .frozen_bn import FROZEN_BN_BWD, FROZEN_BN_FWD
from .nms import aligned_3d_nms, box3d_multiclass_nms, nms_bev, nms_normal_bev
from .sweep import (
    SWEEP_BWD,
    SWEEP_FWD,
    plane_sweep_correlation,
    plane_sweep_correlation_plain,
)

# every kernel's launch counter, by the name chip_smoke.py reports: the
# sweep's, one for each built DFA3D instance ("dfa3d_{fwd,bwd}_{s1,mh}_c<c>",
# "_bd" at bf16 depth: ops/dfa3d.py::counter_name) and the windowed kernels'
# of the sort_queries path ("dfa3d_win_{fwd,bwd}_mh", "_c16" at c = 16:
# ops/dfa3d_windowed.py::win_counter) and ResNet-50's frozen BN epilogue
# (53 launches a forward, 53 a backward)
KERNELS = {
    "sweep_fwd": SWEEP_FWD,
    "sweep_bwd": SWEEP_BWD,
    "frozen_bn_fwd": FROZEN_BN_FWD,
    "frozen_bn_bwd": FROZEN_BN_BWD,
    **DFA3D_COUNTERS,
    **WIN_COUNTERS,
}

__all__ = [
    "KERNELS", "LIBRARY", "plain_ops", "dfa3d_attend", "dfa3d_attention_plain",
    "dfa3d_attention_windowed", "msda_2d_attend",
    "aligned_3d_nms", "box3d_multiclass_nms", "nms_bev", "nms_normal_bev",
    "plane_sweep_correlation", "plane_sweep_correlation_plain",
]
