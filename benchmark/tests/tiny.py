"""cells at a size the CPU runs in seconds: the dt_r50 configuration at
64x96 (4x6 maps, 360 anchors), 128 proposal slots, 32 rois, 16 detections,
d_max 4; two pairs a call, two batches. Its class logits spread less over
rois at this size, so its class head is scaled more."""

from __future__ import annotations

import json

from benchmark import spec

TINY_KEYS = dict(INPUT_SHAPE=[64, 96], EVAL_MAX_ROIS=128, TRAIN_MAX_ROIS=128, MAX_ROIS=32, MAX_DETS=16, D_MAX=4)
TINY_CLS_SCALE = 50.0
TINY_TRAFFIC = dict(pairs_per_call=2, batches=2, warmup_calls=1, kept_share=1.0, check_calls=2, profiled_calls=2)


def config(dtype: str = "float32", name: str = "dt_r50") -> dict:
    with open(spec.HERE / "configs" / f"{name}.json") as f:
        c = json.load(f)
    c["config"].update(TINY_KEYS, COMPUTE_DTYPE=dtype)
    c["weights"]["scale"]["rcnn.cls_sm_conv"] = TINY_CLS_SCALE
    return c


def traffic() -> dict:
    with open(spec.HERE / "traffic" / "pairs4.json") as f:
        t = json.load(f)
    t.update(TINY_TRAFFIC)
    return t


def cell(dtype: str = "float32", limits=None, per_layer=()) -> spec.Cell:
    """the tiny pairs cell; limits default to dt_r50.pairs's."""
    if limits is None:
        limits = spec.load("dt_r50.pairs").limits
    return spec.Cell("tiny.pairs", spec.HERE, 1, config(dtype), traffic(), dict(limits), [], list(per_layer))

