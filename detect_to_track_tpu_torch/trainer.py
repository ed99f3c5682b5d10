"""joint training of the whole detect-and-track model (port of the JAX
package's `trainer.py`: `forward_losses`, `make_optimizer`,
`make_train_step`, `make_eval_step`, `BatchLoader`, `prefetch` and the
checkpointing `DetectTrackTrainer`).

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
`d2t::optimizer`.

`DetectTrackTrainer` runs the reference's loop (train an epoch, validate,
report, early-stop) with the JAX trainer's checkpoints, resume, NaN policy,
host-memory watchdog and JSONL log; `python -m
detect_to_track_tpu_torch.train` drives it. With NUM_DEVICES > 1 it is one
rank of a torch.distributed group (parallel/mesh.py): the step runs under
DistributedDataParallel on the rank's rows of the host batch, the losses
are means over the ranks, rank 0 alone logs, reports and writes the
checkpoints, and the watchdog's decision is all-reduced.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import shutil
import sys
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

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
from .parallel.mesh import Mesh, any_over_ranks, barrier_sync, make_mesh, mean_over_ranks
from .utils import (
    check_model_device,
    image_to_input,
    promote_mixed_image_dtypes,
    resolve_device,
    space_to_depth2,
    split_pairs,
)


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
    float in [0, 1], or (B, 2, H/2, W/2, 12) under HOST_S2D;
    batch.labels.*: (B, 2, L, ...). Returns batch-mean components with
    count 1 (DTLoss.single).
    """
    dev = _model_device(model)
    batch = batch_to_device(batch, dev)
    lbl = batch.labels
    imgs = batch.images
    b, two, h, w, c = imgs.shape
    if two != 2:
        raise ValueError(f"expected (B, 2, H, W, C) frame pairs, got {tuple(imgs.shape)}")
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


class _JointLoss(torch.nn.Module):
    """the joint loss as a module, so that DistributedDataParallel's forward
    runs around it: DDP arms its gradient all-reduce in its own forward."""

    def __init__(self, model: DetectTrackModule, anchors, crosses, cfg: Config) -> None:
        super().__init__()
        self.model = model
        self.anchors, self.crosses, self.cfg = anchors, crosses, cfg

    def forward(self, batch: PaddedPairBatch) -> DTLoss:
        return forward_losses(self.model, batch, self.anchors, self.crosses, self.cfg)


def _ddp(module: torch.nn.Module) -> torch.nn.parallel.DistributedDataParallel:
    """DDP without per-forward buffer broadcasts: the FrozenBN affines are
    constants. The argument's name is chosen by the constructor's signature
    (newer torch names it forward_sync_buffers, older broadcast_buffers)."""
    ddp = torch.nn.parallel.DistributedDataParallel
    params = inspect.signature(ddp.__init__).parameters
    return ddp(module, **{"forward_sync_buffers" if "forward_sync_buffers" in params else "broadcast_buffers": False})


def _with_vector(dtl: DTLoss, vec: torch.Tensor) -> DTLoss:
    return DTLoss(*vec.unbind(), count=dtl.count)


class TrainStep:
    """one joint training step: `step(batch) -> DTLoss` (detached
    components). The model's parameters and the optimizer's momentum are
    updated in place; `steps` counts the updates taken.

    With a `mesh` whose process group is up, `batch` is this rank's rows,
    the loss runs under DistributedDataParallel (the backward all-reduces
    the gradients; GRAD_ACCUM's microbatches but the last run under
    no_sync) and the returned losses are the means over the ranks, so every
    rank takes the same NAN_POLICY decision."""

    def __init__(
        self, model: DetectTrackModule, cfg: Config, optimizer: torch.optim.Optimizer, mesh: Optional[Mesh] = None
    ) -> None:
        self.model = model
        self.cfg = cfg
        self.optimizer = optimizer
        self.steps = 0
        self.accum = max(1, int(cfg.GRAD_ACCUM))
        dev = _model_device(model)
        self.anchors, self.crosses = _anchor_tensors(cfg, dev)
        self.coefs = torch.tensor(cfg.COEFS, dtype=torch.float32, device=dev)
        self.mesh = mesh if mesh is not None and mesh.collective else None
        self._loss = _JointLoss(model, self.anchors, self.crosses, cfg)
        if self.mesh is not None:
            self._loss = _ddp(self._loss)
        self._grads_checked = self.mesh is None

    def _check_grads(self) -> None:
        """DDP waits for the gradient of every trainable parameter: name any
        that the first step left without one."""
        unused = [n for n, p in self.model.named_parameters() if p.requires_grad and p.grad is None]
        if unused:
            raise RuntimeError(f"trainable parameters with no gradient in a step (DDP would wait for them): {unused}")
        self._grads_checked = True

    def __call__(self, batch: PaddedPairBatch) -> DTLoss:
        self.optimizer.zero_grad(set_to_none=True)
        if self.accum == 1:
            dtl = self._loss(batch)
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
            # unsplit step's. Under DDP the gradients are all-reduced once,
            # in the last microbatch's backward.
            total = DTLoss()
            for i in range(self.accum):
                last = i == self.accum - 1
                with self._loss.no_sync() if self.mesh is not None and not last else contextlib.nullcontext():
                    dtl = self._loss(_chunk(batch, i, b // self.accum))
                    with record_function("d2t::backward"):
                        ((self.coefs * dtl.vector()).sum() / self.accum).backward()
                total = total + dtl.detach()
            dtl = total._map(lambda v: v / self.accum)
        if not self._grads_checked:
            self._check_grads()
        if self.mesh is not None:
            dtl = _with_vector(dtl, mean_over_ranks(dtl.vector(), self.mesh))
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
    mesh: Optional[Mesh] = None,
) -> TrainStep:
    """the joint training step for `model` on `device` (cuda unless given;
    the model must lie there). A mesh with a process group makes it the
    data-parallel step (TrainStep)."""
    check_model_device(model, resolve_device(device))
    return TrainStep(model, cfg, optimizer, mesh)


def make_eval_step(
    model: DetectTrackModule, cfg: Config, device: Optional[torch.device] = None, mesh: Optional[Mesh] = None
):
    """`step(batch) -> DTLoss`: the joint loss without gradients; with a
    mesh whose process group is up, the mean over the ranks of their rows'
    losses."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    anchors, crosses = _anchor_tensors(cfg, dev)

    @torch.no_grad()
    def step(batch: PaddedPairBatch) -> DTLoss:
        dtl = forward_losses(model, batch, anchors, crosses, cfg)
        if mesh is not None and mesh.collective:
            dtl = _with_vector(dtl, mean_over_ranks(dtl.vector(), mesh))
        return dtl

    return step


class BatchLoader:
    """shuffled fixed-shape batches of frame pairs from a DataManager,
    packed into PaddedPairBatch numpy arrays (drop_last). PIL sources pack
    as uint8 (divided by 255 on the device); uint8 arrays stay uint8;
    float arrays are taken as [0, 1]; HOST_S2D packs each pair 2x2
    space-to-depth, (2, H/2, W/2, 12). Each epoch's order derives from
    (seed, epoch). cfg.LOADER_WORKERS: 0 = min(batch, cpus) decode threads,
    1 = serial, N = N threads.

    shard = (index, count): the loader yields rows [index * n, (index + 1) *
    n) of each batch of batch_size, n = batch_size / count (a rank's rows of
    its host's batch). Every shard samples the whole batch, in order, so a
    manager that draws from its own rng gives every shard the same batch;
    only its own rows are decoded."""

    def __init__(
        self,
        manager: DataManager,
        batch_size: int,
        cfg: Config,
        seed: int = 0,
        shuffle: bool = True,
        shard: Tuple[int, int] = (0, 1),
    ) -> None:
        index, count = shard
        if batch_size % count or not 0 <= index < count:
            raise ValueError(f"shard {shard} of a batch of {batch_size}: BATCH_SIZE must divide over the host's ranks")
        self.rows = slice(index * batch_size // count, (index + 1) * batch_size // count)
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
        ims = np.stack(promote_mixed_image_dtypes(ims))
        if self.cfg.HOST_S2D:
            ims = space_to_depth2(ims)
        return ims, tuple(frames), dropped

    def __iter__(self) -> Iterator[PaddedPairBatch]:
        n = len(self.manager)
        rng = np.random.RandomState((self.seed * 1_000_003 + self.epoch) % (2**32))
        self.epoch += 1
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        pool = self._decode_pool()
        for s in range(0, n - bs + 1, bs):
            # sampling stays serial (a manager may draw from its own rng)
            # and covers the whole batch; the decode and resize of this
            # shard's rows fan out over the pool
            pairs = [self.manager[int(idx)] for idx in order[s : s + bs]][self.rows]
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


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """host-side prefetch: a background thread keeps `depth` packed batches
    ready while the device trains. An exception in the producer is raised
    in the consumer with its traceback; a consumer that stops early (closes
    the generator) releases the producer, which stops at its next put."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that notices the consumer's shutdown, so the thread
        # never blocks forever holding `depth` decoded batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            q.get_nowait()
        except queue.Empty:
            pass


def _overlay(im, confs: np.ndarray, boxes: np.ndarray, top_n: int = 3):
    """a copy of the frame (PIL, uint8 or [0, 1] float array) with each
    detection's box and its top_n class confidences drawn."""
    from PIL import Image

    from .vis import draw_detections

    if isinstance(im, np.ndarray):
        im = Image.fromarray(im if im.dtype == np.uint8 else (im * 255).astype(np.uint8))
    else:
        im = im.copy()
    labels = [" ".join(f"{c}:{conf[c]:.2f}" for c in np.argsort(-conf)[:top_n]) for conf in confs]
    return draw_detections(im, boxes, labels)


def _active_wandb():
    """the wandb module when a run is active, else None. Only a run that
    the caller started counts (the train entry point does, under
    WANDB_MODE), so wandb is never imported here: its import alone takes
    seconds."""
    wandb = sys.modules.get("wandb")
    return wandb if wandb is not None and getattr(wandb, "run", None) is not None else None


def _host_loss(dtl: DTLoss) -> DTLoss:
    """the components as CPU tensors (one device read per step)."""
    return dtl._map(lambda v: v.detach().cpu())


class DetectTrackTrainer:
    """train / validate / report / early-stop loop (reference
    trainer.py:45-367) with checkpoints and resume, on one device (cuda
    unless `device` is given; the model must lie there).

    NUM_DEVICES > 1: this process is one rank of a process group whose
    world size is NUM_DEVICES (else construction raises), on its own device.
    The rank trains and validates on its rows of its host's batch
    (BATCH_SIZE pairs per host, split over the host's ranks in order), the
    host's training order is salted per host (the loader seed and the
    sampler's reseed), and the losses are means over the ranks, so every
    rank holds the same loss history, early-stopping state and weights.
    Rank 0 alone logs, reports and writes checkpoints; every rank meets the
    others at a barrier after each write and restores on its own device.

    A checkpoint is one `torch.save` file: the model's state_dict, the SGD
    momentum (the optimizer's state_dict) and the step counter, beside a
    `<path>.meta.json` sidecar with the loop's host state. The default
    path `OUTPUT_DIR/ckpt` holds the best model by validation loss and
    keeps a rotating history `ckpt_step_%08d` of CHECKPOINT_KEEP copies;
    the watchdog saves `ckpt_autosave`, the end of `run` `ckpt_final`."""

    def __init__(
        self,
        model: DetectTrackModule,
        trn_manager: DataManager,
        val_manager: DataManager,
        rep_manager: Optional[DataManager],
        cfg: Config,
        logger: Optional[Callable[[Dict], None]] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        # raises unless the world size is NUM_DEVICES (a process with no
        # group is a world of one): NUM_DEVICES 1 under a launcher would
        # train world-size divergent models racing for OUTPUT_DIR
        self.mesh = make_mesh(cfg.NUM_DEVICES, cfg.NUM_HOSTS)
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.optimizer = make_optimizer(cfg, model)
        # DDP only above one rank: a world of one keeps the plain step
        step_mesh = self.mesh if self.mesh.world_size > 1 else None
        self._train_step = make_train_step(model, cfg, self.optimizer, self.device, step_mesh)
        self._eval_step = make_eval_step(model, cfg, self.device, step_mesh)
        shard = (self.mesh.local_index, self.mesh.per_host)
        # the host's training order: the loader's shuffle seed (the stride
        # keeps every host clear of the val loader's seed 1) and, for a
        # seeded sampler, a per-host reseed; the ranks of one host share both
        self.trn_loader = BatchLoader(trn_manager, cfg.BATCH_SIZE, cfg, seed=1_000_003 * self.mesh.host, shard=shard)
        if self.mesh.n_hosts > 1:
            reseed = getattr(trn_manager, "reseed", None)
            if callable(reseed):
                reseed(self._proc_salt(0))
        self.val_loader = BatchLoader(val_manager, cfg.BATCH_SIZE, cfg, seed=1, shuffle=False, shard=shard)
        if len(self.trn_loader) == 0:
            # a zero-batch train loader would "train" nothing while still
            # burning PATIENCE full validation epochs
            raise ValueError(
                f"training manager yields 0 batches ({len(trn_manager)} instances at "
                f"BATCH_SIZE={cfg.BATCH_SIZE}); raise TRN_SIZE or lower BATCH_SIZE"
            )
        if len(self.val_loader) == 0:
            # every val loss would be 0/0: no checkpoint would ever be written
            raise ValueError(
                f"validation manager yields 0 batches ({len(val_manager)} instances at "
                f"BATCH_SIZE={cfg.BATCH_SIZE}); raise VAL_SIZE or lower BATCH_SIZE"
            )
        self.rep_manager = rep_manager
        self._report_detector = None  # built once, on the live model

        self.output_dir = Path(cfg.OUTPUT_DIR)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.logger = logger or self._default_logger

        self.n_iters = 0
        self.best_val_loss = float("inf")
        self.iters_no_improvement = 0
        self._max_iters = float("inf")
        self._coefs = torch.tensor(cfg.COEFS, dtype=torch.float32)
        self._in_validate = False
        self._val_pending = False
        self._profiled = False
        self._rss_limit_cache: Optional[Tuple[float, float]] = None  # (cfg value, GB)
        self._rss_watchdog_disarmed = False
        self._collectives_warm = False
        # host-RSS watchdog hook: called (after an autosave) when the process
        # exceeds cfg.HOST_RSS_LIMIT_GB; the train entry point installs an
        # exec-restart, None warns once and disarms
        self.on_host_memory_limit: Optional[Callable[[], None]] = None

    @property
    def step_count(self) -> int:
        """optimizer updates taken (a skipped non-finite step is not one)."""
        return self._train_step.steps

    def _proc_salt(self, step: int) -> int:
        """the sampler salt at `step`: the step itself with one host, else
        distinct per (host, step), so seeded samplers on different hosts
        never replay each other's draws; the ranks of one host share it."""
        return step * self.mesh.n_hosts + self.mesh.host

    def _default_logger(self, metrics: Dict) -> None:
        """wandb when a run is active, else one JSON line per call in
        OUTPUT_DIR/metrics.jsonl; rank 0 only (one stream per run)."""
        if self.mesh.rank != 0:
            return
        wandb = _active_wandb()
        if wandb is not None:
            wandb.log(metrics)
            return
        scalars = {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float)) or hasattr(v, "__float__")}
        with open(self.output_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(scalars) + "\n")

    def close(self) -> None:
        """stop the loaders' decode threads."""
        self.trn_loader.close()
        self.val_loader.close()

    def _profile(self):
        """a torch.profiler context for the first epoch when PROFILE_DIR is
        set (its trace is written there on exit), else None."""
        if not self.cfg.PROFILE_DIR or self._profiled:
            return None
        from torch.profiler import ProfilerActivity, profile

        self._profiled = True
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        return profile(activities=acts)

    def _warm_collectives(self) -> None:
        """before the first collective of the run (a step, in train or in a
        resumed validate): a barrier, so that no rank starts its first
        all-reduce while another is still building (JAX's
        `_warm_collectives`, which compiles first; here nothing compiles
        ahead, so only the barrier is left)."""
        if not self._collectives_warm:
            barrier_sync("d2t_first_collective")
            self._collectives_warm = True

    def train(self) -> DTLoss:
        trn_loss = DTLoss()
        self._warm_collectives()
        prof = self._profile()
        if prof is not None:
            prof.__enter__()
        try:
            window = DTLoss()
            for batch in prefetch(iter(self.trn_loader)):
                # NAN_POLICY "skip": the step itself leaves the parameters,
                # the momentum and the counter as they were; the host only
                # skips the accumulation
                dtl = _host_loss(self._train_step(batch))
                skipped = not self._check_finite(dtl) and self.cfg.NAN_POLICY == "skip"
                self.n_iters += self.cfg.BATCH_SIZE
                # the watchdog on every batch (skipped or not, whatever
                # LOG_EVERY is): epochs longer than the memory headroom must
                # still autosave in time. Below the limit it is one /proc read.
                self._check_host_memory()
                if skipped:
                    # a skipped batch still spends the instance budget, so
                    # run(max_iters) ends even on a bad shard
                    if self.n_iters >= self._max_iters:
                        break
                    continue
                trn_loss = trn_loss + dtl
                window = window + dtl
                if self.cfg.LOG_EVERY and float(window.count) >= self.cfg.LOG_EVERY:
                    c = float(window.count)
                    self.logger(
                        {f"itr_{k}": float(v) / c for k, v in window.asdict().items()}
                        | {"iter": self.n_iters, "dropped_labels": self.trn_loader.dropped_labels}
                    )
                    window = DTLoss()
                if self.n_iters >= self._max_iters:
                    break  # mid-epoch stop too (smoke runs, budget caps)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                path = Path(self.cfg.PROFILE_DIR)
                path.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(path / "train_epoch.json"))
        return trn_loss

    def _check_finite(self, dtl: DTLoss) -> bool:
        """act on non-finite losses per cfg.NAN_POLICY: "raise" aborts,
        "warn" prints and keeps the update, "skip" prints (the step already
        left the state as it was). Returns True if the losses are finite."""
        vals = [float(v) for v in (dtl.o, dtl.b_rpn, dtl.c, dtl.b_rcnn, dtl.t)]
        if all(np.isfinite(v) for v in vals):
            return True
        msg = f"non-finite loss at iter {self.n_iters}: {dtl!r}"
        if self.cfg.NAN_POLICY == "raise":
            raise FloatingPointError(msg)
        action = "skipping update" if self.cfg.NAN_POLICY == "skip" else "continuing"
        print(f"WARNING: {msg} ({action})")
        return False

    def validate(self) -> DTLoss:
        val_loss = DTLoss()
        # the same per-batch watchdog as train(). _in_validate marks an
        # autosave's sidecar (val_pending), so a restarted process resumes
        # into this validation instead of skipping the epoch's val loss.
        self._in_validate = True
        self._warm_collectives()
        try:
            for batch in prefetch(iter(self.val_loader)):
                val_loss = val_loss + _host_loss(self._eval_step(batch))
                self._check_host_memory()
        finally:
            self._in_validate = False
        return val_loss

    def _report_images(self) -> Dict[str, object]:
        """detection overlays on the fixed report set (reference
        trainer.py:324-340): the Detector on each report pair, boxes and
        the top-3 class confidences drawn, both frames side by side, saved
        under OUTPUT_DIR/report."""
        if self.rep_manager is None or self.mesh.rank != 0:
            # rank 0 alone reports, on the unwrapped model: no collective
            return {}
        from PIL import Image

        from .inference import Detector

        if self._report_detector is None:
            # one Detector for every epoch: it runs the live model
            self._report_detector = Detector(self.model, self.cfg, self.device)
        detector = self._report_detector
        rep_dir = self.output_dir / "report"
        rep_dir.mkdir(exist_ok=True)
        images = {}
        try:
            for n in range(len(self.rep_manager)):
                i0, i1 = self.rep_manager[n]
                confs0, confs1, boxes0, boxes1, _tracks = detector(i0.im, i1.im)
                im0 = _overlay(i0.im, confs0, boxes0)
                im1 = _overlay(i1.im, confs1, boxes1)
                cat = Image.fromarray(np.concatenate([np.array(im0), np.array(im1)], axis=1))
                cat.save(rep_dir / f"pair_{n}.png")
                images[f"pair_{n}"] = cat
        finally:
            self.model.train()  # the Detector put the shared model in eval mode
        return images

    def report(self, trn_loss: DTLoss, val_loss: DTLoss) -> None:
        def avg(dtl: DTLoss, prefix: str) -> Dict[str, float]:
            c = max(float(dtl.count), 1.0)
            return {f"{prefix}_{k}": float(v) / c for k, v in dtl.asdict().items()}

        metrics = {**avg(trn_loss, "trn"), **avg(val_loss, "val")}
        metrics["step"] = self.step_count
        metrics["dropped_labels"] = self.trn_loader.dropped_labels
        images = self._report_images()
        wandb = _active_wandb()
        if wandb is not None and images:
            metrics = dict(metrics) | {k: wandb.Image(im) for k, im in images.items()}
        self.logger(metrics)
        print(" ".join([repr(trn_loss), repr(val_loss)]))

    def checkpoint(self, path: Optional[str] = None) -> None:
        """save the model's state_dict, the optimizer's (SGD momentum) and
        the step counter with torch.save (written to a temporary file, then
        renamed), and the loop's host state in `<path>.meta.json`. The
        default path keeps a rotating history of the last CHECKPOINT_KEEP
        saves beside the latest-best `ckpt`. Rank 0 alone writes; every
        rank then waits at a barrier until the files are there."""
        default = path is None
        path = Path(path or self.output_dir / "ckpt").absolute()
        if self.mesh.rank == 0:
            self._write_checkpoint(path, default)
        barrier_sync("d2t_checkpoint")

    def _write_checkpoint(self, path: Path, default: bool) -> None:
        tmp = path.with_name(path.name + ".tmp")
        torch.save(
            {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step_count},
            tmp,
        )
        os.replace(tmp, path)
        # host-side loop state the weights cannot carry: a resume continues
        # early stopping, progress accounting and the shuffle sequence
        Path(f"{path}.meta.json").write_text(
            json.dumps(
                {
                    "step": self.step_count,
                    "n_iters": self.n_iters,
                    "best_val_loss": self.best_val_loss,
                    "iters_no_improvement": self.iters_no_improvement,
                    "loader_epoch": self.trn_loader.epoch,
                    "dropped_labels": self.trn_loader.dropped_labels,
                    # true only for a watchdog autosave inside validate():
                    # the epoch's val loss was never computed
                    "val_pending": self._in_validate,
                }
            )
        )
        if default and self.cfg.CHECKPOINT_KEEP > 0:
            hist = path.parent / f"ckpt_step_{self.step_count:08d}"
            if not hist.exists():
                shutil.copyfile(path, hist)
            old = sorted(path.parent.glob("ckpt_step_*"))
            for p in old[: -self.cfg.CHECKPOINT_KEEP]:
                p.unlink()

    def _pick_restore_path(self) -> Path:
        """the most recently written of the latest-best `ckpt` and the
        watchdog's `ckpt_autosave`, by sidecar mtime, not by step: a stale
        autosave of an earlier run in the same OUTPUT_DIR may carry a higher
        step and must lose to this run's fresh `ckpt`. Ties go to `ckpt`."""
        best_p, best_mtime = None, -1.0
        for name in ("ckpt_autosave", "ckpt"):
            p = (self.output_dir / name).absolute()
            if not p.exists():
                continue
            try:
                mtime = Path(f"{p}.meta.json").stat().st_mtime
            except OSError:
                mtime = p.stat().st_mtime
            if mtime >= best_mtime:
                best_p, best_mtime = p, mtime
        return best_p or self.output_dir / "ckpt"

    def restore(self, path: Optional[str] = None) -> None:
        """load a checkpoint (by default `_pick_restore_path`): the weights,
        the momentum and the step; `n_iters` rewinds to step * BATCH_SIZE, the
        training sampler is salted with the step (a seeded sampler would
        otherwise replay its stream), and the sidecar, where there is one,
        restores the loop's host state."""
        path = Path(path if path is not None else self._pick_restore_path()).absolute()
        # reset first: a history file (no sidecar) must not inherit a stale
        # val_pending of an earlier restore
        self._val_pending = False
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._train_step.steps = int(state["step"])
        # --max-iters counts total instances on a resume, so the watchdog's
        # exec-restart terminates
        self.n_iters = self.step_count * self.cfg.BATCH_SIZE
        reseed = getattr(self.trn_loader.manager, "reseed", None)
        if callable(reseed):
            reseed(self._proc_salt(self.step_count))
        try:
            meta = json.loads(Path(f"{path}.meta.json").read_text())
        except (OSError, ValueError):
            return
        self.n_iters = int(meta.get("n_iters", self.n_iters))
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        self.iters_no_improvement = int(meta.get("iters_no_improvement", 0))
        self.trn_loader.epoch = int(meta.get("loader_epoch", 0))
        self.trn_loader.dropped_labels = int(meta.get("dropped_labels", 0))
        self._val_pending = bool(meta.get("val_pending", False))

    def step(self) -> None:
        trn_loss = self.train()
        val_loss = self.validate()
        self.report(trn_loss, val_loss)
        self._note_val_result(val_loss)

    def _note_val_result(self, val_loss: DTLoss) -> None:
        """early stopping and the best-`ckpt` save for one epoch's val loss."""
        scalar = float(val_loss.to_scalar(self._coefs))
        if scalar < self.best_val_loss:
            self.best_val_loss = scalar
            self.iters_no_improvement = 0
            self.checkpoint()
        else:
            self.iters_no_improvement += 1

    def _host_rss_limit_gb(self) -> float:
        """cfg.HOST_RSS_LIMIT_GB: 0 disables (inf), > 0 is the bound in GB,
        < 0 is 70% of MemTotal. Cached per cfg value; a failed /proc read
        disables the check for this call only."""
        lim = self.cfg.HOST_RSS_LIMIT_GB
        if self._rss_limit_cache is not None and self._rss_limit_cache[0] == lim:
            return self._rss_limit_cache[1]
        if lim == 0:
            limit = float("inf")
        elif lim > 0:
            limit = float(lim)
        else:
            limit = None
            try:
                with open("/proc/meminfo") as f:
                    for line in f:
                        if line.startswith("MemTotal"):
                            limit = 0.7 * int(line.split()[1]) / 1e6
                            break
            except (OSError, ValueError, IndexError):
                limit = None
            if limit is None:
                return float("inf")
        self._rss_limit_cache = (lim, limit)
        return limit

    @staticmethod
    def _host_rss_gb() -> float:
        """the current resident set in GB, or 0.0 (watchdog inert) where it
        cannot be read (ru_maxrss is a lifetime peak that survives execve,
        so it would re-trip the limit after every restart)."""
        try:
            page = os.sysconf("SC_PAGE_SIZE")
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * page / 1e9
        except (OSError, IndexError, ValueError):
            return 0.0

    def _check_host_memory(self) -> None:
        """above cfg.HOST_RSS_LIMIT_GB: autosave to `ckpt_autosave` (never
        the latest-best `ckpt`; restore() picks the newer of the two) and
        call `on_host_memory_limit`; with no handler, warn once and disarm."""
        if self._rss_watchdog_disarmed:
            return
        limit = self._host_rss_limit_gb()
        # with several ranks every rank joins the all-reduce of the "over"
        # flag on every call unless the config disables the watchdog: a
        # rank whose /proc read failed (limit inf) still takes part
        collective = self.mesh.world_size > 1 and self.cfg.HOST_RSS_LIMIT_GB != 0
        if limit == float("inf") and not collective:
            return
        rss_gb = self._host_rss_gb()
        over = rss_gb > limit
        if collective:
            # if any rank is over, all autosave together and all run the
            # handler (the checkpoint's barrier needs every rank)
            over = any_over_ranks(over, self.mesh, self.device)
        if not over:
            return
        print(
            f"WARNING: host RSS {rss_gb:.1f} GB exceeds HOST_RSS_LIMIT_GB={limit:.1f} (on this or another rank); "
            f"autosaving at step {self.step_count}"
        )
        self.checkpoint(self.output_dir / "ckpt_autosave")
        if self.on_host_memory_limit is not None:
            self.on_host_memory_limit()
        else:
            self._rss_watchdog_disarmed = True
            print(
                "WARNING: no on_host_memory_limit handler installed; watchdog disarmed after one autosave "
                "(install a handler or restart the process to re-arm)"
            )

    def run(self, max_iters: float = float("inf")) -> None:
        self._max_iters = max_iters
        if self._val_pending:
            # the restored autosave was written inside validate(): finish
            # that epoch's validation first, so its early-stopping comparison
            # and best-`ckpt` save are not lost; an empty train loss keeps
            # the report's keys
            self._val_pending = False
            val_loss = self.validate()
            print(f"resumed validation: {val_loss!r}")
            self.report(DTLoss(), val_loss)
            self._note_val_result(val_loss)
        while not (self.iters_no_improvement > self.cfg.PATIENCE or self.n_iters >= max_iters):
            self.step()
            if self.iters_no_improvement > self.cfg.PATIENCE or self.n_iters >= max_iters:
                break  # done: no exec-restart just to exit
            self._check_host_memory()
        # the endpoint of a bounded run under its own name (never the
        # latest-best `ckpt`, never in the history)
        self.checkpoint(self.output_dir / "ckpt_final")
        # a clean end drops the watchdog's autosave, so it cannot shadow a
        # later run's checkpoints in a reused OUTPUT_DIR
        auto = self.output_dir / "ckpt_autosave"
        if self.mesh.rank == 0 and auto.exists():
            auto.unlink()
            Path(f"{auto}.meta.json").unlink(missing_ok=True)
