"""sampling / sequence utilities (a copy of the JAX package's
`data/sampling.py`, which imports no JAX).

The `ml_utils` surface the reference depends on: partition_items
(data.misc), sliding_window (sequence), plus the discrete-Laplacian
frame-stride distribution the reference gets from scipy (reference
data/imagenet.py:11,72).
"""

from __future__ import annotations

import itertools
import random
from typing import Iterable, Iterator, List, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


def partition_items(
    items: Sequence[T], sizes: Sequence[float]
) -> Tuple[List[T], ...]:
    """partition items into len(sizes) contiguous chunks with fractional
    sizes (ml_utils.data.misc.partition_items parity; used at reference
    imagenet.py:357 for the 80/20 train/val snippet split)."""
    total = sum(sizes)
    fractions = [s / total for s in sizes]
    n = len(items)
    bounds = np.floor(np.cumsum([0.0] + fractions) * n).astype(int)
    bounds[-1] = n
    return tuple(
        list(items[bounds[i] : bounds[i + 1]]) for i in range(len(sizes))
    )


def sliding_window(iterable: Iterable[T], size: int) -> Iterator[Tuple[T, ...]]:
    """overlapping windows of the given size
    (ml_utils.sequence.sliding_window parity; used at reference
    viterbi.py:64)."""
    iters = itertools.tee(iterable, size)
    for shift, it in enumerate(iters):
        for _ in range(shift):
            next(it, None)
    return zip(*iters)


def sample_dlaplace(a: float, rng: random.Random) -> int:
    """one draw from the discrete Laplacian distribution
    PMF f(x) = tanh(a/2) * exp(-a|x|), x integer (reference imagenet.py:72
    uses scipy.stats.dlaplace).

    Sampled by inverse CDF: |X| ~ geometric-like with p = 1 - exp(-a),
    sign uniform (X=0 only from the |X|=0 atom)."""
    if not a > 0:
        # a = 0 would divide by log(q=1) = 0 (int(-inf) -> OverflowError
        # deep in the train loop); a < 0 is not a distribution at all.
        raise ValueError(f"dlaplace needs a > 0, got a={a}")
    # P(X = 0) = tanh(a/2) = (1-q)/(1+q) with q = exp(-a); conditional on
    # X != 0, |X| is geometric over {1, 2, ...} with success prob (1 - q):
    # P(X = +-k) = tanh(a/2) * q^k for k >= 1, splitting evenly over signs.
    if rng.random() < np.tanh(a / 2):
        return 0
    q = np.exp(-a)
    r = rng.random()
    k = int(np.floor(np.log1p(-r) / np.log(q))) + 1  # inverse geometric CDF
    k = max(k, 1)
    return k if rng.random() < 0.5 else -k


def sample_bernoulli(p: float, rng: random.Random) -> bool:
    """Bernoulli(p) draw (reference imagenet.py:243 uses scipy bernoulli)."""
    return rng.random() < p
