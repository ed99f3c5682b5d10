"""proposal filtering: confidence gate -> top-k -> greedy NMS -> capacity cap.

Port of the JAX package's `ops/nms.py`, batched over a leading frame axis.
Every sort is stable and score-descending, so ties go to the lower index as
`jax.lax.top_k` and `jnp.argsort` order them: NMS keep-sets and compaction
then match the JAX package exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..boxes import compute_ious, compute_ious_np


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


def nms_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """exact greedy NMS keep-mask over score-descending candidates.

    Iterates keep <- valid & ~any_{j<i}(keep[j] & overlaps[j, i]) from
    keep = valid to its fixed point, which is the greedy result (every
    index whose suppression chain is at most t long is final after t
    iterations). Bounded by k iterations, as in the JAX package; each
    iteration's convergence test reads one flag back to the host.

    boxes: (..., k, 4); valid: (..., k) bool. Returns keep (..., k) bool.
    """
    k = boxes.shape[-2]
    overlaps = compute_ious(boxes, boxes) > iou_thresh  # (..., k, k)
    order = torch.arange(k, device=boxes.device)
    sup = overlaps & (order[:, None] < order[None, :])  # j suppresses i > j
    keep = valid
    for _ in range(k):
        new = valid & ~(keep[..., :, None] & sup).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


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
