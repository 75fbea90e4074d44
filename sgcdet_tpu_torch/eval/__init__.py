"""Evaluation of the port: the indoor mAP protocol (sgcdet_tpu/eval/)."""
from .indoor_eval import average_precision, eval_det_cls, eval_map_recall, indoor_eval

__all__ = ["average_precision", "eval_det_cls", "eval_map_recall", "indoor_eval"]
