"""proposal filtering: confidence gate -> top-k -> greedy NMS -> capacity cap.

Port of the JAX package's `ops/nms.py`, batched over a leading frame axis.
Every sort is stable and score-descending, so ties go to the lower index as
`jax.lax.top_k` and `jnp.argsort` order them: NMS keep-sets and compaction
then match the JAX package exactly.

The greedy NMS is the registered op `d2t::nms_mask` (`nms_mask`): on CUDA
tensors it launches the hand-written kernel `csrc/nms.cu` (the whole
keep-mask on the card, no host read), on CPU tensors it runs the plain
fixed-point loop `nms_mask_ref`. Its fake gives `torch.export` the output's
shape, so the proposal filter traces into an exported graph.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..boxes import compute_ious, compute_ious_np
from . import _build
from .correlation import _MAX_SMEM_BYTES


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (..., k, 4) ijhw, score-descending
    scores: torch.Tensor  # (..., k)
    valid: torch.Tensor  # (..., k) bool


def _top_k(x: torch.Tensor, k: int):
    """descending top-k along the last axis, lower index first on ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, F) or (..., N) gathered at idx (..., k) along N."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def top_k_proposals(
    scores: torch.Tensor, boxes: torch.Tensor, conf_thresh: float, k: int
) -> Proposals:
    """confidence gate + top-k (ConfidenceFilter -> MaxDetFilter).

    scores: (..., |A|); boxes: (..., |A|, 4).
    """
    k = min(k, scores.shape[-1])
    gated = torch.where(scores > conf_thresh, scores, torch.full_like(scores, -torch.inf))
    top_scores, idx = _top_k(gated, k)
    return Proposals(
        boxes=_take_rows(boxes, idx),
        scores=top_scores,
        valid=torch.isfinite(top_scores),
    )


def nms_mask_ref(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """exact greedy NMS keep-mask over score-descending candidates: the
    plain version of the kernel.

    Iterates keep <- valid & ~any_{j<i}(keep[j] & overlaps[j, i]) from
    keep = valid to its fixed point, which is the greedy result (every
    index whose suppression chain is at most t long is final after t
    iterations). Bounded by k iterations, as in the JAX package; each
    iteration's convergence test reads one flag back to the host.

    boxes: (..., k, 4); valid: (..., k) bool. Returns keep (..., k) bool, a
    new tensor (never `valid` itself).
    """
    k = boxes.shape[-2]
    overlaps = compute_ious(boxes, boxes) > iou_thresh  # (..., k, k)
    order = torch.arange(k, device=boxes.device)
    sup = overlaps & (order[:, None] < order[None, :])  # j suppresses i > j
    keep = valid.clone()
    for _ in range(k):
        new = valid & ~(keep[..., :, None] & sup).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _nms_lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    lib.d2t_nms_mask.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.d2t_nms_mask.restype = ctypes.c_int
    lib.d2t_nms_iou_bits.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                             ctypes.c_void_p]
    lib.d2t_nms_iou_bits.restype = ctypes.c_int
    lib.d2t_nms_sweep_smem_bytes.argtypes = [ctypes.c_int]
    lib.d2t_nms_sweep_smem_bytes.restype = ctypes.c_size_t
    return lib


def nms_mask_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """launch the NMS kernel (csrc/nms.cu) on (..., k, 4) float32 ijhw boxes,
    score-descending, and (..., k) bool CUDA tensors, any k >= 1: the IoU
    bit mask (its words at or above the diagonal alone), then one block per
    frame resolves it 64 slots at a time in index order. Returns keep
    (..., k) bool, bitwise nms_mask_ref's. Counts each call (two launches)
    in `nms_mask_cuda.launches`."""
    if not (boxes.is_cuda and valid.is_cuda) or boxes.device != valid.device:
        raise ValueError(f"the NMS kernel needs CUDA tensors on one device, got {boxes.device} and {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"the NMS kernel takes float32 boxes and a bool mask, got {boxes.dtype} and {valid.dtype}")
    if boxes.dim() < 2 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:-1]:
        raise ValueError(f"expected (..., k, 4) boxes and a (..., k) mask, got {tuple(boxes.shape)} and "
                         f"{tuple(valid.shape)}")
    k = boxes.shape[-2]
    b = valid.numel() // max(k, 1)
    if k < 1 or not 1 <= b <= 65535:
        raise ValueError(f"the NMS kernel takes 1-65535 frames of k >= 1 slots, got {b} frames of {k}")
    lib = _nms_lib()
    smem = lib.d2t_nms_sweep_smem_bytes(k)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"k={k} slots need a {smem}-byte bitset in shared memory, more than the "
                         f"{_MAX_SMEM_BYTES} a Hopper block can use")
    nw = -(-k // 64)
    flat_boxes = boxes.reshape(b, k, 4).contiguous()
    flat_valid = valid.reshape(b, k).contiguous()
    mask = torch.empty((b, k, nw), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.d2t_nms_mask(
            flat_boxes.data_ptr(), flat_valid.data_ptr(), mask.data_ptr(), keep.data_ptr(), b, k, iou_thresh, stream
        )
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: CUDA error {err}")
    nms_mask_cuda.launches += 1
    return keep.reshape(valid.shape)


nms_mask_cuda.launches = 0


def nms_iou_bits_ref(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """the plain version of nms_iou_bits_cuda: (B, k, 4) boxes -> (B, k,
    ceil(k / 64)) int64 words, bit t of word w of row i set iff j = 64 w +
    t > i, j < k and compute_ious > iou_thresh (the words below the
    diagonal are 0)."""
    b, k = boxes.shape[:2]
    nw = -(-k // 64)
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    bits = torch.zeros(b, k, nw * 64, dtype=torch.bool, device=boxes.device)
    bits[..., :k] = (compute_ious(boxes, boxes) > iou_thresh) & upper
    weights = torch.ones(64, dtype=torch.int64, device=boxes.device) << torch.arange(64, device=boxes.device)
    return (bits.view(b, k, nw, 64).to(torch.int64) * weights).sum(-1)  # distinct bits: the sum is their OR


def nms_iou_bits_cuda(boxes: torch.Tensor, iou_thresh: float, out: torch.Tensor) -> torch.Tensor:
    """a test hook, not on the main path: the NMS kernel's first launch alone
    (the IoU bits) on (B, k, 4) float32 ijhw CUDA boxes into `out`, a
    (B, k, ceil(k / 64)) int64 tensor on their device. Bit t of word w of
    row i, for the words at or above the diagonal (w >= i // 64), is set
    iff j = 64 w + t > i, j < k and compute_ious > iou_thresh; the words
    below the diagonal are left as they were. Returns `out`; counts no
    launch."""
    if not boxes.is_cuda or boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"expected (B, k, 4) float32 CUDA boxes, got {boxes.dtype} {tuple(boxes.shape)} on "
                         f"{boxes.device}")
    b, k = boxes.shape[:2]
    if out.device != boxes.device or out.dtype != torch.int64 or out.shape != (b, k, -(-k // 64)) \
            or not out.is_contiguous():
        raise ValueError(f"expected a contiguous ({b}, {k}, {-(-k // 64)}) int64 scratch on {boxes.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    flat_boxes = boxes.contiguous()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _nms_lib().d2t_nms_iou_bits(flat_boxes.data_ptr(), out.data_ptr(), b, k, iou_thresh, stream)
    if err != 0:
        raise RuntimeError(f"NMS IoU launch failed: CUDA error {err}")
    return out


@torch.library.custom_op("d2t::nms_mask", mutates_args=(), device_types="cpu")
def nms_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """exact greedy NMS keep-mask over score-descending candidates, the op
    `d2t::nms_mask`: slot i is kept iff valid and no kept slot j < i has IoU
    > iou_thresh with it. The kernel for CUDA tensors (nms_mask_cuda), the
    plain fixed-point loop for CPU tensors (nms_mask_ref).

    boxes: (..., k, 4); valid: (..., k) bool. Returns keep (..., k) bool.
    """
    return nms_mask_ref(boxes, valid, iou_thresh)


nms_mask.register_kernel("cuda")(nms_mask_cuda)


@nms_mask.register_fake
def _nms_mask_fake(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    return torch.empty_like(valid)


def proposal_filter(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    pre_nms_topk: int,
    conf_thresh: float,
    nms_iou_thresh: float,
    max_rois: int,
    pre_nms_cap: Optional[int] = None,
) -> Proposals:
    """gate -> top-k -> NMS -> cap, for one frame ((|A|,), (|A|, 4)) or a
    batch of frames ((B, |A|), (B, |A|, 4)).

    pre_nms_cap, when below pre_nms_topk, invalidates the score-descending
    slots beyond it (3072 slots, 3000 of them eligible at the default
    config). Returns Proposals with (..., max_rois, 4) boxes, survivors
    first in score order; dropped slots carry score 0 and valid False.
    """
    p = top_k_proposals(scores, boxes, conf_thresh, pre_nms_topk)
    n = p.valid.shape[-1]  # == min(pre_nms_topk, |A|)
    if pre_nms_cap is not None and pre_nms_cap < n:
        in_cap = torch.arange(n, device=scores.device) < pre_nms_cap
        p = Proposals(
            boxes=p.boxes,
            scores=torch.where(in_cap, p.scores, torch.full_like(p.scores, -torch.inf)),
            valid=p.valid & in_cap,
        )
    keep = nms_mask(p.boxes, p.valid, nms_iou_thresh)

    # compact survivors to the front in score order: kept slots sort by
    # their own index, dropped ones by n (stable, so in index order).
    idx = torch.arange(n, device=scores.device).expand_as(keep)
    key = torch.where(keep, idx, torch.full_like(idx, n))
    order = torch.argsort(key, dim=-1, stable=True)[..., :max_rois]
    kept = torch.gather(keep, -1, order)
    out = Proposals(
        boxes=_take_rows(p.boxes, order),
        scores=torch.where(kept, torch.gather(p.scores, -1, order), torch.zeros((), device=scores.device)),
        valid=kept,
    )
    if n < max_rois:  # tiny configs: |A| < max_rois
        pad = max_rois - n
        out = Proposals(
            boxes=torch.nn.functional.pad(out.boxes, (0, 0, 0, pad)),
            scores=torch.nn.functional.pad(out.scores, (0, pad)),
            valid=torch.nn.functional.pad(out.valid, (0, pad)),
        )
    return out


def batched_proposal_filter(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    pre_nms_topk: int,
    conf_thresh: float,
    nms_iou_thresh: float,
    max_rois: int,
    pre_nms_cap: Optional[int] = None,
) -> Proposals:
    """proposal_filter over a leading batch axis: scores (B, |A|), boxes
    (B, |A|, 4)."""
    if scores.dim() != 2:
        raise ValueError(f"expected (B, |A|) scores, got {tuple(scores.shape)}")
    return proposal_filter(
        scores, boxes, pre_nms_topk, conf_thresh, nms_iou_thresh, max_rois, pre_nms_cap
    )


def nms_np(scores: np.ndarray, boxes: np.ndarray, iou_thresh: float) -> np.ndarray:
    """host-side numpy greedy NMS (ml_utils NMSFilter parity); indices of the
    kept boxes in score-descending order."""
    order = np.argsort(-scores, kind="stable")
    ious = compute_ious_np(boxes, boxes)
    kept = []
    suppressed = np.zeros(len(scores), bool)
    for i in order:
        if suppressed[i]:
            continue
        kept.append(i)
        suppressed |= ious[i] > iou_thresh
    return np.asarray(kept, np.int64)
