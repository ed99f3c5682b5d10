"""losses for detection and tracking, and the DTLoss accumulator (port of
the JAX package's `losses.py`).

- focal loss on ALREADY-SOFTMAXED probabilities (the reference subclasses
  nn.BCELoss), log terms clamped at -100 as torch.nn.BCELoss does;
- bbox loss: smooth-L1 (beta 1) meaned over the 4 coordinates, zero at
  negative anchors;
- RPN loss: (lw * focal).mean() + bbox.mean() over all anchors of the batch;
- RCNN and track losses: masked means over valid slots, 0 when none is
  valid;
- DTLoss: the five named components and an instance count, with `+`,
  `to_scalar(coefs)` and the reference's compact repr.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

import torch

_LOG_CLAMP = -100.0  # torch.nn.BCELoss clamps log terms at -100


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log clamped at -100 with a NaN-free gradient at x == 0: the log runs
    on 1 there, so its 1/x never meets the where's zero cotangent.

    Subnormal x counts as 0, as in the JAX package, whose XLA flushes
    subnormals to zero on the CPU and the TPU. Taken at face value, a
    saturated softmax's p ~ 1e-40 gives log(p) > -100, so the clamp passes
    the gradient 1/p, which overflows to inf and turns the softmax's
    backward into NaN."""
    bad = x < torch.finfo(x.dtype).tiny
    safe = torch.where(bad, torch.ones_like(x), x)
    return torch.where(bad, torch.full_like(x, _LOG_CLAMP), torch.log(safe).clamp(min=_LOG_CLAMP))


def _bce(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """elementwise binary cross-entropy on probabilities, torch-compatible."""
    return -(y * _safe_log(p) + (1.0 - y) * _safe_log(1.0 - p))


def focal_loss(c_hat: torch.Tensor, c_star: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """focal loss on class probabilities: c_hat (..., C) softmaxed,
    c_star (...,) int -> (...,) mean over classes."""
    onehot = torch.nn.functional.one_hot(c_star.long(), c_hat.shape[-1]).to(c_hat.dtype)
    is_t = onehot == 1
    pt = torch.where(is_t, 1.0 - c_hat, c_hat)
    at = torch.where(is_t, 1.0 - alpha, alpha).to(c_hat.dtype)
    return ((pt**gamma) * at * _bce(c_hat, onehot)).mean(dim=-1)


def smooth_l1(x: torch.Tensor, y: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """elementwise smooth-L1 (torch.nn.SmoothL1Loss, reduction='none')."""
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def bbox_loss(b_hat: torch.Tensor, b_star: torch.Tensor, c_star: torch.Tensor) -> torch.Tensor:
    """(..., 4) offsets -> (...,) smooth-L1 meaned over coords, zeroed at
    negative anchors."""
    l1 = smooth_l1(b_hat, b_star).mean(dim=-1)
    return torch.where(c_star == 0, torch.zeros_like(l1), l1)


def rpn_loss(lw, o_hat, o_star, b_hat, b_star, alpha: float, gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """RPN objectness and regression losses.

    lw (B, |A|) anchor loss weights; o_hat (B, |A|, 2) softmaxed; o_star
    (B, |A|) int in {0, 1}; b_hat / b_star (B, |A|, 4).
    """
    o_l = (lw * focal_loss(o_hat, o_star, alpha, gamma)).mean()
    b_l = bbox_loss(b_hat, b_star, o_star).mean()
    return o_l, b_l


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean over the last axis of the entries where mask is True; 0 where
    nothing is valid. Masked-out entries are dropped with `where`, not
    multiplied, so garbage in padding slots cannot poison the mean or its
    gradient. x, mask (..., N) -> (...)."""
    mask = mask.bool()
    count = mask.sum(dim=-1).to(x.dtype)
    total = torch.where(mask, x, torch.zeros_like(x)).sum(dim=-1)
    return torch.where(count > 0, total / count.clamp(min=1.0), torch.zeros_like(total))


def rcnn_loss(c_hat, c_star, b_hat, b_star, valid, alpha: float, gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """RCNN classification and regression losses over one instance's
    regions: c_hat (..., N, C) softmaxed, c_star (..., N) int, b_hat /
    b_star (..., N, 4), valid (..., N) bool. Leading axes are instances."""
    c_l = _masked_mean(focal_loss(c_hat, c_star, alpha, gamma), valid)
    b_l = _masked_mean(bbox_loss(b_hat, b_star, c_star), valid)
    return c_l, b_l


def track_loss(t_hat: torch.Tensor, t_star: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """smooth-L1 track regression loss: mean over all coordinates of the
    valid tracks of one instance, 0 when none is valid. t_hat, t_star
    (..., L, 4), valid (..., L)."""
    return _masked_mean(smooth_l1(t_hat, t_star).mean(dim=-1), valid)


def _zero() -> torch.Tensor:
    return torch.zeros(())


_FIELDS = ("o", "b_rpn", "c", "b_rcnn", "t")


@dataclasses.dataclass
class DTLoss:
    """the five named loss components and the instance count. Accumulate
    with `+`, reduce with `to_scalar(coefs)`."""

    o: torch.Tensor = dataclasses.field(default_factory=_zero)
    b_rpn: torch.Tensor = dataclasses.field(default_factory=_zero)
    c: torch.Tensor = dataclasses.field(default_factory=_zero)
    b_rcnn: torch.Tensor = dataclasses.field(default_factory=_zero)
    t: torch.Tensor = dataclasses.field(default_factory=_zero)
    count: torch.Tensor = dataclasses.field(default_factory=_zero)

    @classmethod
    def single(cls, o, b_rpn, c, b_rcnn, t) -> "DTLoss":
        """one instance's losses (count = 1)."""
        return cls(o=o, b_rpn=b_rpn, c=c, b_rcnn=b_rcnn, t=t, count=torch.ones((), device=o.device))

    def _map(self, fn) -> "DTLoss":
        return DTLoss(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def __add__(self, other: "DTLoss") -> "DTLoss":
        return DTLoss(**{f.name: getattr(self, f.name) + getattr(other, f.name) for f in dataclasses.fields(self)})

    def detach(self) -> "DTLoss":
        return self._map(torch.Tensor.detach)

    def vector(self) -> torch.Tensor:
        """(5,) the components in the order o, b_rpn, c, b_rcnn, t."""
        return torch.stack([getattr(self, k) for k in _FIELDS])

    def to_scalar(self, coefs: Optional[Sequence[float]] = None) -> torch.Tensor:
        """linear combination / count; an empty accumulator (count 0)
        reduces to 0, not 0/0."""
        vec = self.vector()
        coefs = torch.ones(5, dtype=vec.dtype) if coefs is None else torch.as_tensor(coefs, dtype=vec.dtype)
        total = (coefs.to(vec.device) * vec).sum()
        count = self.count.to(vec.device)
        return torch.where(count > 0, total / count.clamp(min=1), torch.zeros_like(total))

    def asdict(self) -> dict:
        """component dict with the reference's short keys."""
        return {"o": self.o, "a": self.b_rpn, "c": self.c, "r": self.b_rcnn, "t": self.t}

    def __repr__(self) -> str:
        """compact scientific notation, e.g. `o:1.23e-1 a:...`."""
        count = max(float(self.count), 1.0)
        return " ".join(
            re.sub(r"e([+-])0(\d)", lambda m: f"e{m.group(1)}{m.group(2)}", f"{k}:{float(v) / count:.2e}")
            for k, v in self.asdict().items()
        )
