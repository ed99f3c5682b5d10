"""joint training of the whole detect-and-track model (port of the JAX
package's `trainer.py`: `forward_losses`, `make_optimizer`,
`make_train_step`, `make_eval_step` and `BatchLoader`).

One forward computes all five losses for a batch of frame pairs: backbone,
RPN with its anchor targets, the proposal filter, R-FCN with its region
targets, and the correlation tracker with its track targets. One backward
and one SGD step follow. The targets are encoded on the device.

Semantics kept from the reference (each as the JAX package keeps them):
- approximate joint training: no gradient flows from the proposals back to
  the RPN (the scores and decoded boxes are detached);
- per-instance averaging: the RCNN and track losses are per-pair masked
  means (a pair's two frames together), averaged over the batch;
- torch SGD: grad + wd * p -> momentum -> -lr, on the trainable parameters
  only (the stem and the stages below FIRST_TRAINABLE_STAGE are frozen);
- GRAD_ACCUM sums the unnormalised numerators over microbatches, then
  divides once, which equals the unsplit step;
- NAN_POLICY "skip": a non-finite loss leaves the parameters, the momentum
  and the step counter as they were.

Each stage runs inside a `torch.profiler.record_function` range named
`d2t::<stage>`, the backward inside `d2t::backward` and the update inside
`d2t::optimizer`. The checkpointing trainer, `prefetch` and the CLIs are
not ported yet (ROADMAP.md item 9).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .anchors import anchor_boundary_mask, build_anchors
from .config import Config
from .data.types import DataManager, PaddedFrame, PaddedPairBatch, pack_labels
from .encoding import anchor_encode, frcnn_box_decode, region_encode, track_encode
from .losses import DTLoss, rcnn_loss, rpn_loss, track_loss
from .models import DetectTrackModule, set_trainable_stages
from .ops.nms import batched_proposal_filter
from .utils import check_model_device, image_to_input, promote_mixed_image_dtypes, resolve_device, split_pairs


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _anchor_tensors(cfg: Config, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """the static anchors (|A|, 4) and their boundary-crossing mask (|A|,)."""
    anchors = np.array(build_anchors(cfg.fm_shape, cfg.ANCHOR_AREAS, cfg.ANCHOR_ASPECT_RATIOS))
    crosses = anchor_boundary_mask(anchors)
    return torch.from_numpy(anchors).to(device), torch.from_numpy(crosses).to(device)


def batch_to_device(batch: PaddedPairBatch, device: torch.device) -> PaddedPairBatch:
    """the batch's numpy arrays as tensors on `device`."""
    lbl = batch.labels
    return PaddedPairBatch(
        images=torch.as_tensor(batch.images).to(device),
        labels=PaddedFrame(*(torch.as_tensor(a).to(device) for a in lbl)),
    )


def forward_losses(
    model: DetectTrackModule,
    batch: PaddedPairBatch,
    anchors: torch.Tensor,
    crosses_boundary: torch.Tensor,
    cfg: Config,
) -> DTLoss:
    """the joint loss of a batch of frame pairs, on the model's device.

    batch.images: (B, 2, H, W, 3) uint8 (divided by 255 on the device) or
    float in [0, 1]; batch.labels.*: (B, 2, L, ...). Returns batch-mean
    components with count 1 (DTLoss.single).
    """
    dev = _model_device(model)
    batch = batch_to_device(batch, dev)
    lbl = batch.labels
    imgs = batch.images
    b, two, h, w, c = imgs.shape
    if two != 2:
        raise ValueError(f"expected (B, 2, H, W, 3) frame pairs, got {tuple(imgs.shape)}")
    flat = lambda a: a.reshape((b * 2,) + tuple(a.shape[2:]))  # noqa: E731 -- frame f of pair p at 2p+f
    boxes_f, classes_f, mask_f = flat(lbl.boxes), flat(lbl.classes), flat(lbl.mask)

    with record_function("d2t::backbone"):
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        fmaps = model.backbone(imgs.reshape(b * 2, h, w, c))

    with record_function("d2t::rpn"):
        at = anchor_encode(
            anchors, crosses_boundary, boxes_f, classes_f, mask_f, cfg.ENCODER_IOU_THRESH, cfg.ENCODER_IOU_MARGIN
        )
        o_hat, b_hat, fm_reg = model.rpn(fmaps["c4"])
        o_star = (at.c_star != 0).to(torch.int32)
        o_loss, b_loss_rpn = rpn_loss(at.loss_weights, o_hat, o_star, b_hat, at.b_star, cfg.ALPHA, cfg.GAMMA)

    with record_function("d2t::proposal_filter"), torch.no_grad():
        # approximate joint training: no gradient through the proposals
        scores = o_hat[:, :, 1].detach()
        rboxes = frcnn_box_decode(anchors[None], b_hat.detach())
        props = batched_proposal_filter(
            scores,
            rboxes,
            cfg.pre_nms_topk_train,
            cfg.TRAIN_ROI_CONF_THRESH,
            cfg.TRAIN_NMS_IOU_THRESH,
            cfg.MAX_ROIS,
            cfg.pre_nms_cap_train,
        )

    with record_function("d2t::rcnn"):
        rt = region_encode(
            props.boxes, boxes_f, classes_f, mask_f, cfg.ENCODER_IOU_THRESH, cfg.FIX_REGION_MASK_POLARITY
        )
        c_hat, b2_hat = model.rcnn(fmaps["c5"], props.boxes)
        # per-pair masked means over the pair's 2R region slots, then the batch mean
        pair = lambda a: a.reshape((b, 2 * cfg.MAX_ROIS) + tuple(a.shape[2:]))  # noqa: E731
        c_losses, b2_losses = rcnn_loss(
            pair(c_hat), pair(rt.c_star), pair(b2_hat), pair(rt.b_star), pair(props.valid), cfg.ALPHA, cfg.GAMMA
        )
        c_loss, b_loss_rcnn = c_losses.mean(), b2_losses.mean()

    with record_function("d2t::tracker"):
        tt = track_encode(
            lbl.boxes[:, 0], lbl.classes[:, 0], lbl.track_ids[:, 0], lbl.mask[:, 0],
            lbl.boxes[:, 1], lbl.classes[:, 1], lbl.track_ids[:, 1], lbl.mask[:, 1],
        )
        # c3 is downsampled at full batch, before the pair split, as in
        # inference; the tracker passes it through
        fmaps_t = {**fmaps, "c3": fmaps["c3"][:, ::2, ::2, :]}
        split = {k: split_pairs(v) for k, v in fmaps_t.items()}
        pyr0 = {k: v[0] for k, v in split.items()}
        pyr1 = {k: v[1] for k, v in split.items()}
        t_hat = model.c_tracker(pyr0, pyr1, *split_pairs(fm_reg), tt.rois)  # (B, L, 4)
        t_loss = track_loss(t_hat, tt.t_star, tt.valid).mean()

    return DTLoss.single(o_loss, b_loss_rpn, c_loss, b_loss_rcnn, t_loss)


def make_optimizer(cfg: Config, model: DetectTrackModule) -> torch.optim.SGD:
    """torch SGD (dampening 0, no Nesterov) over the trainable parameters:
    the stem and the backbone stages below cfg.FIRST_TRAINABLE_STAGE are
    frozen (requires_grad=False) and get no update and no decay. The same
    update as the JAX package's chain of weight decay, trace and -lr."""
    kw = dict(cfg.SGD_KWARGS)
    return torch.optim.SGD(
        set_trainable_stages(model, cfg.FIRST_TRAINABLE_STAGE),
        lr=kw["lr"],
        momentum=kw.get("momentum", 0.0),
        weight_decay=kw.get("weight_decay", 0.0),
    )


def _chunk(batch: PaddedPairBatch, i: int, n: int) -> PaddedPairBatch:
    sl = slice(i * n, (i + 1) * n)
    return PaddedPairBatch(images=batch.images[sl], labels=PaddedFrame(*(a[sl] for a in batch.labels)))


class TrainStep:
    """one joint training step: `step(batch) -> DTLoss` (detached
    components). The model's parameters and the optimizer's momentum are
    updated in place; `steps` counts the updates taken."""

    def __init__(self, model: DetectTrackModule, cfg: Config, optimizer: torch.optim.Optimizer) -> None:
        self.model = model
        self.cfg = cfg
        self.optimizer = optimizer
        self.steps = 0
        self.accum = max(1, int(cfg.GRAD_ACCUM))
        dev = _model_device(model)
        self.anchors, self.crosses = _anchor_tensors(cfg, dev)
        self.coefs = torch.tensor(cfg.COEFS, dtype=torch.float32, device=dev)

    def _losses(self, batch: PaddedPairBatch) -> DTLoss:
        return forward_losses(self.model, batch, self.anchors, self.crosses, self.cfg)

    def __call__(self, batch: PaddedPairBatch) -> DTLoss:
        self.optimizer.zero_grad(set_to_none=True)
        if self.accum == 1:
            dtl = self._losses(batch)
            with record_function("d2t::backward"):
                dtl.to_scalar(self.coefs).backward()
            dtl = dtl.detach()
        else:
            b = len(batch.images)
            if b % self.accum:
                raise ValueError(f"BATCH_SIZE {b} must divide over GRAD_ACCUM {self.accum}")
            # only one microbatch's activations are live at a time. Each
            # microbatch's unnormalised numerator (coefs . losses) goes
            # backward divided by the count, so the summed gradients are the
            # unsplit step's.
            total = DTLoss()
            for i in range(self.accum):
                dtl = self._losses(_chunk(batch, i, b // self.accum))
                with record_function("d2t::backward"):
                    ((self.coefs * dtl.vector()).sum() / self.accum).backward()
                total = total + dtl.detach()
            dtl = total._map(lambda v: v / self.accum)
        if self.cfg.NAN_POLICY == "skip" and not bool(torch.isfinite(dtl.vector()).all()):
            # the update, the momentum and the counter stay as they were
            self.optimizer.zero_grad(set_to_none=True)
            return dtl
        with record_function("d2t::optimizer"):
            self.optimizer.step()
        self.steps += 1
        return dtl


def make_train_step(
    model: DetectTrackModule,
    cfg: Config,
    optimizer: torch.optim.Optimizer,
    device: Optional[torch.device] = None,
) -> TrainStep:
    """the joint training step for `model` on `device` (cuda unless given;
    the model must lie there)."""
    check_model_device(model, resolve_device(device))
    return TrainStep(model, cfg, optimizer)


def make_eval_step(model: DetectTrackModule, cfg: Config, device: Optional[torch.device] = None):
    """`step(batch) -> DTLoss`: the joint loss without gradients."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    anchors, crosses = _anchor_tensors(cfg, dev)

    @torch.no_grad()
    def step(batch: PaddedPairBatch) -> DTLoss:
        return forward_losses(model, batch, anchors, crosses, cfg)

    return step


class BatchLoader:
    """shuffled fixed-shape batches of frame pairs from a DataManager,
    packed into PaddedPairBatch numpy arrays (drop_last). PIL sources pack
    as uint8 (divided by 255 on the device); uint8 arrays stay uint8;
    float arrays are taken as [0, 1]. Each epoch's order derives from
    (seed, epoch). cfg.LOADER_WORKERS: 0 = min(batch, cpus) decode threads,
    1 = serial, N = N threads."""

    def __init__(self, manager: DataManager, batch_size: int, cfg: Config, seed: int = 0, shuffle: bool = True) -> None:
        if cfg.HOST_S2D:
            raise NotImplementedError("HOST_S2D (the 12-channel space-to-depth stem) is not ported yet (ROADMAP.md)")
        self.manager = manager
        self.batch_size = batch_size
        self.cfg = cfg
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        # labels beyond MAX_LABELS are dropped by pack_labels; counted here
        self.dropped_labels = 0
        self._pool = None

    def _decode_pool(self):
        workers = self.cfg.LOADER_WORKERS or min(self.batch_size, os.cpu_count() or 1)
        if workers <= 1:
            return None
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="d2t-decode")
        return self._pool

    def close(self) -> None:
        """stop the decode threads, if any were started."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _pack_pair(self, pair) -> Tuple[np.ndarray, Tuple[PaddedFrame, PaddedFrame], int]:
        """decode, resize and pack one instance pair (thread-safe): images
        (2, H, W, 3), the two packed label frames, dropped-label count."""
        ims, frames, dropped = [], [], 0
        for inst in pair:
            if isinstance(inst.im, np.ndarray):
                ims.append(inst.im if inst.im.dtype == np.uint8 else inst.im.astype(np.float32))
            else:
                ims.append(image_to_input(inst.im, self.cfg.INPUT_SHAPE, as_uint8=True))
            dropped += max(0, len(inst.labels) - self.cfg.MAX_LABELS)
            frames.append(pack_labels(inst.labels, self.cfg.MAX_LABELS))
        return np.stack(promote_mixed_image_dtypes(ims)), tuple(frames), dropped

    def __iter__(self) -> Iterator[PaddedPairBatch]:
        n = len(self.manager)
        rng = np.random.RandomState((self.seed * 1_000_003 + self.epoch) % (2**32))
        self.epoch += 1
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        pool = self._decode_pool()
        for s in range(0, n - bs + 1, bs):
            # sampling stays serial (a manager may draw from its own rng);
            # the decode and resize fan out over the pool
            pairs = [self.manager[int(idx)] for idx in order[s : s + bs]]
            packed = list(pool.map(self._pack_pair, pairs)) if pool is not None else [self._pack_pair(p) for p in pairs]
            for _, _, dropped in packed:
                if dropped and self.dropped_labels == 0:
                    print(
                        f"WARNING: frame(s) exceed MAX_LABELS={self.cfg.MAX_LABELS}; dropping overflow "
                        "(counted in dropped_labels)"
                    )
                self.dropped_labels += dropped
            images = promote_mixed_image_dtypes([ims for ims, _, _ in packed])
            labels = [frames for _, frames, _ in packed]
            stack = lambda field: np.stack([np.stack([f0[field], f1[field]]) for f0, f1 in labels])  # noqa: E731
            yield PaddedPairBatch(images=np.stack(images), labels=PaddedFrame(*(stack(i) for i in range(4))))

    def __len__(self) -> int:
        return len(self.manager) // self.batch_size
