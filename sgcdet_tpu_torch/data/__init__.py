"""Host data pipeline of the port (sgcdet_tpu/data/): the infos-pkl
datasets, per-view preprocessing and the prefetching scene loader."""
from .datasets import CBGSDataset, MultiViewDataset, load_infos
from .loader import SceneLoader, pad_gt
from .pipeline import (
    load_and_preprocess_image,
    load_depth_map,
    prepare_scene,
    sample_view_ids,
    scene_poses,
)

__all__ = [
    "CBGSDataset", "MultiViewDataset", "load_infos", "SceneLoader", "pad_gt",
    "load_and_preprocess_image", "load_depth_map", "prepare_scene",
    "sample_view_ids", "scene_poses",
]
