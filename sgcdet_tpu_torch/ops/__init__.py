"""Ops of the port: the hand-written Hopper kernels behind their wrappers,
their plain PyTorch versions, and host-side NMS."""
from ._cuda import LIBRARY, plain_ops
from .dfa3d import (
    DFA3D_BWD_MH,
    DFA3D_BWD_MH_BD,
    DFA3D_BWD_S1,
    DFA3D_BWD_S1_BD,
    DFA3D_FWD_MH,
    DFA3D_FWD_MH_BD,
    DFA3D_FWD_S1,
    DFA3D_FWD_S1_BD,
    dfa3d_attend,
    dfa3d_attention_plain,
    msda_2d_attend,
)
from .dfa3d_windowed import (
    DFA3D_WIN_BWD_MH,
    DFA3D_WIN_FWD_MH,
    DFA3D_WIN_FWD_S1,
    dfa3d_attention_windowed,
)
from .nms import aligned_3d_nms
from .sweep import (
    SWEEP_BWD,
    SWEEP_FWD,
    plane_sweep_correlation,
    plane_sweep_correlation_plain,
)

# every kernel of the serving, train, 2D lifting and sorted paths, by the
# name chip_smoke.py reports ("_bd": the bf16-depth instances of the 2D path;
# "_win": the windowed kernels of the sort_queries path)
KERNELS = {
    "sweep_fwd": SWEEP_FWD,
    "dfa3d_fwd_s1": DFA3D_FWD_S1,
    "dfa3d_fwd_mh": DFA3D_FWD_MH,
    "sweep_bwd": SWEEP_BWD,
    "dfa3d_bwd_s1": DFA3D_BWD_S1,
    "dfa3d_bwd_mh": DFA3D_BWD_MH,
    "dfa3d_fwd_s1_bd": DFA3D_FWD_S1_BD,
    "dfa3d_fwd_mh_bd": DFA3D_FWD_MH_BD,
    "dfa3d_bwd_s1_bd": DFA3D_BWD_S1_BD,
    "dfa3d_bwd_mh_bd": DFA3D_BWD_MH_BD,
    "dfa3d_win_fwd_s1": DFA3D_WIN_FWD_S1,
    "dfa3d_win_fwd_mh": DFA3D_WIN_FWD_MH,
    "dfa3d_win_bwd_mh": DFA3D_WIN_BWD_MH,
}

__all__ = [
    "KERNELS", "LIBRARY", "plain_ops", "dfa3d_attend", "dfa3d_attention_plain",
    "dfa3d_attention_windowed", "msda_2d_attend",
    "aligned_3d_nms", "plane_sweep_correlation", "plane_sweep_correlation_plain",
]
