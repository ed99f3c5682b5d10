"""numerical diagnostics (port of the JAX package's `diagnostics.py`).

The trainer enforces cfg.NAN_POLICY on every step's losses; this module
localizes which loss component went non-finite, for debugging runs. JAX
uses `checkify` there; here each component is tested with
`torch.isfinite`, and the contract is kept: the wrapped function returns
(error, DTLoss), and `error.throw()` raises naming the first non-finite
component.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .losses import DTLoss


class CheckError:
    """the outcome of a checked call: `get()` is the message, or None when
    every component was finite; `throw()` raises FloatingPointError with
    it."""

    def __init__(self, message: Optional[str] = None) -> None:
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked_loss_fn(loss_fn: Callable[..., DTLoss]) -> Callable[..., Tuple[CheckError, DTLoss]]:
    """wrap a loss function (*args) -> DTLoss; the wrapper returns
    (CheckError, DTLoss), the error naming the first component (in
    `DTLoss.asdict` order: o, a, c, r, t) that is not finite. One host read
    per call."""

    def checked(*args, **kwargs) -> Tuple[CheckError, DTLoss]:
        dtl = loss_fn(*args, **kwargs)
        names = list(dtl.asdict())
        finite = torch.isfinite(torch.stack([torch.as_tensor(v).float() for v in dtl.asdict().values()]))
        bad = [n for n, ok in zip(names, finite.tolist()) if not ok]
        return CheckError(f"loss component '{bad[0]}' is non-finite" if bad else None), dtl

    return checked
