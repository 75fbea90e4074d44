"""Device ms of the ResNet-50 and the FPN a scene (SGCDet.backbone, .neck)."""
from benchmark.readers import stage_ms

HOOKS = ("backbone", "neck")


def read(trace):
    return stage_ms(trace, HOOKS)
