"""Evaluation of the port (sgcdet_tpu/eval/): the indoor mAP protocol and
the sharded eval's detection gather."""
from .gather import gather_detections, load_shard, save_shard
from .indoor_eval import average_precision, eval_det_cls, eval_map_recall, indoor_eval

__all__ = ["average_precision", "eval_det_cls", "eval_map_recall", "indoor_eval",
           "gather_detections", "load_shard", "save_shard"]
