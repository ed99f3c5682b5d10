"""configuration: the reference's flat UPPER_CASE YAML schema plus the
static-capacity knobs, exactly as the JAX package reads it, so one config
file drives both packages. Unknown keys raise; bad values raise in
`__post_init__`. `compute_dtype` is a torch dtype here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class Config:
    """all hyperparameters. Defaults match the reference cfg/default.yaml."""

    # --- data ---
    DATA_ROOT: str = ""
    VID_PARTITION_SIZES: Tuple[float, float] = (0.8, 0.2)
    TRN_SIZE: int = 10000
    VAL_SIZE: int = 5000
    REP_SIZE: int = 15
    P_DET: float = 0.5  # probability of sampling from DET instead of VID
    A: float = 0.8  # shape parameter for discrete laplacian distribution
    N_CLASSES: int = 30
    BATCH_SIZE: int = 4

    # --- anchors ---
    ANCHOR_AREAS: Tuple[float, ...] = (0.001, 0.004, 0.016, 0.064, 0.256)
    ANCHOR_ASPECT_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)

    # --- encoding ---
    ENCODER_IOU_THRESH: float = 0.5
    ENCODER_IOU_MARGIN: float = 0.2

    # --- region filtering ---
    TRAIN_ROI_CONF_THRESH: float = 0.3
    TRAIN_MAX_ROIS: int = 3000
    TRAIN_NMS_IOU_THRESH: float = 0.5

    # --- detector settings ---
    EVAL_ROI_CONF_THRESH: float = 0.3
    EVAL_MAX_ROIS: int = 3000
    EVAL_NMS_IOU_THRESH: float = 0.3
    EVAL_RCNN_CONF_THRESH: float = 0.3

    # --- loss ---
    ALPHA: float = 0.25
    GAMMA: float = 2.0
    COEFS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0e-4)

    # --- optimizer ---
    SGD_KWARGS: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"lr": 1e-2, "weight_decay": 1e-4, "momentum": 0.9}
    )

    PATIENCE: int = 1000  # iterations with no improvement before quitting

    # --- model ---
    BACKBONE_ARCH: str = "resnet50"
    FIRST_TRAINABLE_STAGE: int = 3
    INPUT_SHAPE: Tuple[int, int] = (608, 1200)
    FM_STRIDE: int = 16
    D_MAX: int = 8  # max displacement for pointwise correlation
    K: int = 7  # pooled map height and width

    # --- static capacities (not in the reference) ---
    MAX_LABELS: int = 32  # per-frame ground-truth object capacity
    # proposals entering NMS. None honors TRAIN_MAX_ROIS / EVAL_MAX_ROIS
    # (rounded up to a multiple of 128, capped at |A|).
    PRE_NMS_TOPK: Optional[int] = None
    MAX_ROIS: int = 256  # NMS survivors entering the R-FCN head
    MAX_DETS: int = 128  # final detections per frame (see `max_dets`)

    # quirk flags: False replicates the reference, True fixes it.
    FIX_REGION_MASK_POLARITY: bool = False
    FIX_PSROI_CHANNEL_MAP: bool = False

    # compute precision of the backbone and head convolutions and matmuls
    COMPUTE_DTYPE: str = "bfloat16"
    # host-side 2x2 space-to-depth input with the 4x4/s1 stem (not ported
    # yet: the port raises when it is set)
    HOST_S2D: bool = False
    LOADER_WORKERS: int = 0
    REMAT: bool = False
    GRAD_ACCUM: int = 1
    NAN_POLICY: str = "warn"
    HOST_RSS_LIMIT_GB: float = -1.0

    # parallelism
    NUM_DEVICES: int = 1
    MESH_AXES: Tuple[str, ...] = ("data",)
    NUM_HOSTS: int = 1

    # observability / checkpointing
    OUTPUT_DIR: str = "output"
    LOG_EVERY: int = 10
    CHECKPOINT_KEEP: int = 3
    PROFILE_DIR: str = ""

    def __post_init__(self) -> None:
        h, w = self.INPUT_SHAPE
        if h % self.FM_STRIDE or w % self.FM_STRIDE:
            raise ValueError(
                f"INPUT_SHAPE {self.INPUT_SHAPE} must be a multiple of "
                f"FM_STRIDE {self.FM_STRIDE}: the anchor grid is built from "
                f"INPUT_SHAPE // FM_STRIDE and would mismatch the backbone's "
                f"actual feature map"
            )
        if self.HOST_S2D and (h % 2 or w % 2):
            raise ValueError(
                f"HOST_S2D requires even INPUT_SHAPE, got {self.INPUT_SHAPE}"
            )
        if self.COMPUTE_DTYPE not in ("float32", "bfloat16"):
            raise ValueError(
                f"COMPUTE_DTYPE must be 'float32' or 'bfloat16', got "
                f"{self.COMPUTE_DTYPE!r} (e.g. 'bf16' would silently train "
                f"in float32 otherwise)"
            )
        if self.NAN_POLICY not in ("warn", "raise", "skip"):
            raise ValueError(
                f"NAN_POLICY must be 'warn', 'raise' or 'skip', got "
                f"{self.NAN_POLICY!r}"
            )
        if not self.A > 0:
            raise ValueError(
                f"A (discrete-Laplacian stride shape) must be > 0, got "
                f"{self.A}: a=0 overflows the inverse-CDF draw mid-training "
                f"and a<0 is not a distribution"
            )

    @property
    def compute_dtype(self) -> torch.dtype:
        """the torch dtype for COMPUTE_DTYPE."""
        return torch.bfloat16 if self.COMPUTE_DTYPE == "bfloat16" else torch.float32

    @property
    def n_anchors_per_cell(self) -> int:
        return len(self.ANCHOR_AREAS) * len(self.ANCHOR_ASPECT_RATIOS)

    @property
    def fm_shape(self) -> Tuple[int, int]:
        h, w = self.INPUT_SHAPE
        return (h // self.FM_STRIDE, w // self.FM_STRIDE)

    @property
    def n_anchors(self) -> int:
        fh, fw = self.fm_shape
        return fh * fw * self.n_anchors_per_cell

    @property
    def max_dets(self) -> int:
        """effective per-frame detection capacity: at most MAX_ROIS proposals
        survive NMS, so more than MAX_ROIS detection slots cannot fill."""
        return min(self.MAX_DETS, self.MAX_ROIS)

    def _derived_topk(self, max_rois: int) -> int:
        if self.PRE_NMS_TOPK is not None:
            return min(self.PRE_NMS_TOPK, self.n_anchors)
        return min(-(-max_rois // 128) * 128, self.n_anchors)

    @property
    def pre_nms_topk_train(self) -> int:
        """proposal slots entering NMS during training."""
        return self._derived_topk(self.TRAIN_MAX_ROIS)

    @property
    def pre_nms_topk_eval(self) -> int:
        """proposal slots entering NMS at inference."""
        return self._derived_topk(self.EVAL_MAX_ROIS)

    def _derived_cap(self, max_rois: int) -> int:
        """the exact MaxDetFilter capacity: of the pre_nms_topk_* slots
        (3072 at the default config) only this many (3000) score-descending
        ones may enter NMS."""
        if self.PRE_NMS_TOPK is not None:
            return min(self.PRE_NMS_TOPK, self.n_anchors)
        return min(max_rois, self.n_anchors)

    @property
    def pre_nms_cap_train(self) -> int:
        return self._derived_cap(self.TRAIN_MAX_ROIS)

    @property
    def pre_nms_cap_eval(self) -> int:
        return self._derived_cap(self.EVAL_MAX_ROIS)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


_TUPLE_FIELDS = {
    "VID_PARTITION_SIZES",
    "ANCHOR_AREAS",
    "ANCHOR_ASPECT_RATIOS",
    "COEFS",
    "INPUT_SHAPE",
    "MESH_AXES",
}


def load_config(path: Optional[str] = None, **overrides) -> Config:
    """load a Config from a flat-key YAML file plus keyword overrides."""
    raw: Dict = {}
    if path is not None:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    raw.update(overrides)

    valid = {f.name for f in dataclasses.fields(Config)}
    unknown = set(raw) - valid
    if unknown:
        raise KeyError(f"unknown config keys: {sorted(unknown)}")

    for k in list(raw):
        if k in _TUPLE_FIELDS and isinstance(raw[k], (list, tuple)):
            raw[k] = tuple(raw[k])
    return Config(**raw)


def save_config(cfg: Config, path: str) -> None:
    import yaml

    d = dataclasses.asdict(cfg)
    for k in _TUPLE_FIELDS:
        d[k] = list(d[k])
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)
