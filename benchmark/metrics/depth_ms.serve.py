"""Device ms of the depth net a scene (SGCDet.depth_head: the matching net,
the sweep K1, the U-Nets)."""
from benchmark.readers import stage_ms

HOOKS = ("depth_head",)


def read(trace):
    return stage_ms(trace, HOOKS)
