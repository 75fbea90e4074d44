"""Device ms of the sparse volume a scene (SGCDet.voxel_head: compaction,
DFA3D, fusion, occupancy top-k)."""
from benchmark.readers import stage_ms

HOOKS = ("voxel_head",)


def read(trace):
    return stage_ms(trace, HOOKS)
