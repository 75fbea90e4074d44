"""torch modules of the port, one per module of sgcdet_tpu/models/."""
from .detector import SGCDet

__all__ = ["SGCDet"]
