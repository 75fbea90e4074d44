"""Configuration of the port: every field of sgcdet_tpu/configs/config.py,
with the same names, order and defaults (the options the port does not run,
``sweep_band``, ``depth_remat`` and ``use_gt_dpt``, are refused by
``SGCDet``), the four released configs (``get_config``): ScanNet,
ARKitScenes and their -L variants, the CLI's ``section.key=value``
overrides (``apply_overrides``) and its ``config.json`` dump
(``config_json``).

``SGCDet``, ``decode_bboxes``, ``compute_losses`` and the train step read
attributes only, so the JAX package's configs work in their place; the tests
hold every config here field by field against the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

SCANNET_CLASSES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "showercurtrain",
    "toilet", "sink", "bathtub", "garbagebin",
)

ARKIT_CLASSES = (
    "cabinet", "refrigerator", "shelf", "stove", "bed", "sink", "washer",
    "toilet", "bathtub", "oven", "dishwasher", "fireplace", "stool", "chair",
    "table", "tv_monitor", "sofa",
)

# the 189 ScanNet200 classes the -L config detects (configs/
# SGCDet_large_ScanNet200.py of the reference), in its label order
SCANNET200_CLASSES = (
    'wall', 'chair', 'floor', 'table', 'door', 'couch', 'cabinet', 'shelf', 'desk',
    'office chair', 'bed', 'pillow', 'sink', 'picture', 'window', 'toilet', 'bookshelf',
    'monitor', 'curtain', 'book', 'armchair', 'coffee table', 'box', 'refrigerator',
    'lamp', 'kitchen cabinet', 'towel', 'clothes', 'tv', 'nightstand', 'counter',
    'dresser', 'stool', 'cushion', 'plant', 'ceiling', 'bathtub', 'end table',
    'dining table', 'keyboard', 'bag', 'backpack', 'toilet paper', 'printer',
    'tv stand', 'whiteboard', 'blanket', 'shower curtain', 'trash can', 'closet',
    'stairs', 'microwave', 'stove', 'shoe', 'computer tower', 'bottle', 'bin',
    'ottoman', 'bench', 'board', 'washing machine', 'mirror', 'copier', 'basket',
    'sofa chair', 'file cabinet', 'fan', 'laptop', 'shower', 'paper', 'person',
    'paper towel dispenser', 'oven', 'blinds', 'rack', 'plate', 'blackboard', 'piano',
    'suitcase', 'rail', 'radiator', 'recycling bin', 'container', 'wardrobe',
    'soap dispenser', 'telephone', 'bucket', 'clock', 'stand', 'light',
    'laundry basket', 'pipe', 'clothes dryer', 'guitar', 'toilet paper holder', 'seat',
    'speaker', 'column', 'ladder', 'bathroom stall', 'shower wall', 'cup', 'jacket',
    'storage bin', 'coffee maker', 'dishwasher', 'paper towel roll', 'machine', 'mat',
    'windowsill', 'bar', 'toaster', 'bulletin board', 'ironing board', 'fireplace',
    'soap dish', 'kitchen counter', 'doorframe', 'toilet paper dispenser',
    'mini fridge', 'fire extinguisher', 'ball', 'hat', 'shower curtain rod',
    'water cooler', 'paper cutter', 'tray', 'shower door', 'pillar', 'ledge',
    'toaster oven', 'mouse', 'toilet seat cover dispenser', 'furniture', 'cart',
    'scale', 'tissue box', 'light switch', 'crate', 'power outlet', 'decoration',
    'sign', 'projector', 'closet door', 'vacuum cleaner', 'plunger', 'stuffed animal',
    'headphones', 'dish rack', 'broom', 'range hood', 'dustpan', 'hair dryer',
    'water bottle', 'handicap bar', 'vent', 'shower floor', 'water pitcher', 'mailbox',
    'bowl', 'paper bag', 'projector screen', 'divider', 'laundry detergent',
    'bathroom counter', 'object', 'bathroom vanity', 'closet wall', 'laundry hamper',
    'bathroom stall door', 'ceiling light', 'trash bin', 'dumbbell', 'stair rail',
    'tube', 'bathroom cabinet', 'closet rod', 'coffee kettle', 'shower head',
    'keyboard piano', 'case of water bottles', 'coat rack', 'folded chair',
    'fire alarm', 'power strip', 'calendar', 'poster', 'potted plant', 'mattress',
)


@dataclass(frozen=True)
class TestConfig:
    nms_pre: int = 1000
    score_thr: float = 0.01
    iou_thr: float = 0.25  # aligned 3D NMS threshold (ScanNet head)
    nms_thr: float = 0.15  # rotated BEV NMS threshold (ARKit head)
    use_rotate_nms: bool = False


@dataclass(frozen=True)
class ModelConfig:
    embed_dims: int = 256
    n_classes: int = 18
    n_reg_outs: int = 6
    head_type: str = "scannet"  # 'scannet' (aligned boxes) | 'sunrgbd' (yawed)
    # adaptive sparse volume (coarse -> fine)
    voxel_size_list: Tuple[Tuple[float, float, float], ...] = (
        (0.64, 0.64, 0.8),
        (0.32, 0.32, 0.4),
        (0.16, 0.16, 0.2),
    )
    n_voxels_list: Tuple[Tuple[int, int, int], ...] = (
        (10, 10, 4),
        (20, 20, 8),
        (40, 40, 16),
    )
    topk_list: Tuple[int, ...] = (800, 6400)
    # depth head
    dbound: Tuple[float, float, float] = (0.2, 5.0, 0.4)
    neighbor_img_num: int = 2
    # the banded plane sweep (XLA only in the JAX package): not ported,
    # SGCDet refuses any value but None
    sweep_band: int | None = None
    # losses; the depth loss reads GT depth maps at downsample_factor x the
    # stride-4 prediction grid
    downsample_factor: int = 8
    depth_loss_weight: float = 0.5
    depth_max_tol: int = 0
    # rematerialize the depth net in the backward: not ported, SGCDet
    # refuses True
    depth_remat: bool = False
    # attention (num_levels and attn_dropout are read by no model path, as
    # in the JAX package)
    num_heads: int = 8
    num_points: int = 4
    num_levels: int = 1
    ffn_dropout: float = 0.1
    attn_dropout: float = 0.0
    # per-camera visible-query compaction budget: a fraction of K for every
    # level, a tuple of per-level fractions (1.0 disables a level), or None
    # (off); see visibility.derive_visibility_budgets for an exact one
    visibility_budget: float | Tuple[float, ...] | None = None
    # order each camera's compacted queries by projected pixel (no budget
    # then compacts at B = K) and sample through the windowed DFA3D kernels;
    # an exact permutation
    sort_queries: bool = False
    # 3D neck and detection head
    neck3d_out_channels: int = 128
    neck3d_n_blocks: Tuple[int, ...] = (1, 1, 1)
    n_scales: int = 3
    limit: int = 27
    centerness_topk: int = 18
    occ_loss: bool = True
    depth_loss: bool = False
    # supervise with the one-hot GT depth: not ported, SGCDet refuses True
    use_gt_dpt: bool = False
    # 'bfloat16' (default) or 'float32'; BatchNorm statistics, the depth
    # softmax, sampling coordinates and kernel accumulation stay f32
    compute_dtype: str = "bfloat16"
    test_cfg: TestConfig = field(default_factory=TestConfig)

    @property
    def depth_channels(self) -> int:
        return round((self.dbound[1] - self.dbound[0]) / self.dbound[2])

    @property
    def n_voxels(self):
        return self.n_voxels_list[-1]

    @property
    def voxel_size(self):
        return self.voxel_size_list[-1]


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "scannet"  # scannet | scannet200 | arkit
    data_root: str = "data/scannet/"
    ann_train: str = "scannet_infos_train.pkl"
    ann_val: str = "scannet_infos_val.pkl"
    classes: Tuple[str, ...] = SCANNET_CLASSES
    n_images_train: int = 40
    n_images_test: int = 100
    sample_method_train: str = "random"  # random | uniform_random | linear
    # resize target (w, h) keep-ratio, then pad to pad_size (h, w)
    img_scale: Tuple[int, int] = (320, 240)
    pad_size: Tuple[int, int] = (240, 320)
    # static resized (pre-pad) shape for the dataset's native resolution;
    # ScanNet 968x1296 -> (239, 320)
    img_shape: Tuple[int, int] = (239, 320)
    ori_shape: Tuple[int, int] = (968, 1296)
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    depth_shift: float = 1000.0
    origin: str = "fixed"  # fixed [0, 0, .5] | pose_center (ARKit)
    shift_origin_std: Tuple[float, float, float] = (0.7, 0.7, 0.0)
    repeat_times: int = 6
    filter_empty_gt: bool = True
    max_boxes: int = 128  # static GT padding


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    weight_decay: float = 1e-4
    training_steps: int = 1201 * 36
    pct_start: float = 0.05
    final_div_factor: float = 1e4
    div_factor: float = 25.0  # initial lr = max lr / 25
    grad_clip: float = 35.0
    backbone_lr_mult: float = 0.1
    batch_size_per_device: int = 1


@dataclass(frozen=True)
class SGCDetConfig:
    name: str = "sgcdet_scannet"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def scannet() -> SGCDetConfig:
    """configs/SGCDet_ScanNet.py"""
    return SGCDetConfig(name="sgcdet_scannet")


def arkit() -> SGCDetConfig:
    """configs/SGCDet_ARKit.py: yawed boxes (the 'sunrgbd' head, rotated IoU
    loss, rotated BEV NMS) on ARKitScenes' 1440x1920 frames."""
    return SGCDetConfig(
        name="sgcdet_arkit",
        model=ModelConfig(
            n_classes=len(ARKIT_CLASSES),
            n_reg_outs=7,
            head_type="sunrgbd",
            downsample_factor=4,
            test_cfg=TestConfig(score_thr=0.0, nms_thr=0.15, use_rotate_nms=True),
        ),
        data=DataConfig(
            dataset="arkit",
            data_root="data/arkit/",
            ann_train="arkit_infos_train.pkl",
            ann_val="arkit_infos_val.pkl",
            classes=ARKIT_CLASSES,
            sample_method_train="uniform_random",
            img_shape=(240, 320),
            ori_shape=(1440, 1920),
            origin="pose_center",
            repeat_times=3,
        ),
        train=TrainConfig(training_steps=4498 * 18),
    )


# the sparse volume of the -L configs: one level finer (80 x 80 x 32 at
# 8 cm), 8x the top-k, and half the embedding width (c = 128 at stage 1,
# 16 a head at stage 2)
_LARGE_SPARSE = dict(
    voxel_size_list=((0.32, 0.32, 0.4), (0.16, 0.16, 0.2), (0.08, 0.08, 0.1)),
    n_voxels_list=((20, 20, 8), (40, 40, 16), (80, 80, 32)),
    topk_list=(6400, 51200),
    embed_dims=128,
)


def scannet200_large() -> SGCDetConfig:
    """configs/SGCDet_large_ScanNet200.py: ScanNet200's 189 classes on
    ScanNet's frames."""
    return SGCDetConfig(
        name="sgcdet_large_scannet200",
        model=ModelConfig(n_classes=len(SCANNET200_CLASSES), **_LARGE_SPARSE),
        data=DataConfig(
            dataset="scannet200",
            ann_train="scannet200_infos_train.pkl",
            ann_val="scannet200_infos_val.pkl",
            classes=SCANNET200_CLASSES,
            repeat_times=3,
        ),
        train=TrainConfig(training_steps=1201 * 45),
    )


def arkit_large() -> SGCDetConfig:
    """configs/SGCDet_large_ARKit.py: ``arkit`` with the -L sparse volume."""
    base = arkit()
    return dataclasses.replace(
        base,
        name="sgcdet_large_arkit",
        model=dataclasses.replace(base.model, **_LARGE_SPARSE),
    )


_REGISTRY = {
    "scannet": scannet,
    "arkit": arkit,
    "scannet200_large": scannet200_large,
    "arkit_large": arkit_large,
}


def get_config(name: str) -> SGCDetConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown config '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def apply_overrides(config: SGCDetConfig, overrides) -> SGCDetConfig:
    """Apply ``section.key=value`` strings onto a (frozen) config
    (sgcdet_tpu/configs/config.py::apply_overrides): values are parsed with
    ast.literal_eval (falling back to the raw string), and dotted paths
    descend nested dataclasses, e.g. ``model.embed_dims=32`` or
    ``model.test_cfg.nms_pre=100``.  An unknown field raises KeyError, an
    item without ``=`` ValueError."""
    import ast

    def set_path(obj, path, value):
        key = path[0]
        if not hasattr(obj, key):
            raise KeyError(
                f"config has no field '{key}' at {type(obj).__name__}"
            )
        if len(path) == 1:
            return dataclasses.replace(obj, **{key: value})
        return dataclasses.replace(
            obj, **{key: set_path(getattr(obj, key), path[1:], value)}
        )

    for item in overrides or ():
        path_s, _, value_s = item.partition("=")
        if not _:
            raise ValueError(f"override '{item}' is not of the form key=value")
        try:
            value = ast.literal_eval(value_s)
        except (ValueError, SyntaxError):
            value = value_s
        config = set_path(config, path_s.strip().split("."), value)
    return config


def config_json(config: SGCDetConfig) -> str:
    """The ``config.json`` the CLI writes into a run's log folder (the
    JAX package's bytes for the same config)."""
    import json

    return json.dumps(dataclasses.asdict(config), indent=2, default=str)
