"""Device ms of the 3D neck and the detection head a scene (SGCDet.neck_3d,
.bbox_head)."""
from benchmark.readers import stage_ms

HOOKS = ("neck_3d", "bbox_head")


def read(trace):
    return stage_ms(trace, HOOKS)
