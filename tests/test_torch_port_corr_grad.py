"""gradients of the port's correlation (autograd through the plain version,
the CPU form of the corr_bwd_fm0 / corr_bwd_fm1 kernels) held against the
JAX package's Pallas backward kernels run in interpret mode, as
tests/test_ops_correlation.py runs them, on the same numpy inputs and the
same cotangent. The cases cover both regimes of the TPU's dFM1 kernels:
`_bwd_fm1_single_tile_kernel` (K3, H <= 40) and the halo'd `_bwd_fm1_kernel`
(K4, H > 40), which the port's one kernel replaces."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu.ops.correlation import pointwise_correlation as jax_corr
from detect_to_track_tpu_torch.ops.correlation import pointwise_correlation

# (name, B, H, W, C, d_max, stride)
CASES = [
    ("K3", 1, 10, 11, 5, 2, 1),
    ("K3 stride 2", 2, 9, 8, 3, 2, 2),
    ("K3 C=384", 1, 12, 9, 384, 2, 1),
    ("K4 d8", 1, 48, 20, 8, 8, 1),
    ("K4 stride 2", 1, 44, 12, 4, 3, 2),
    ("K4 C=384", 1, 48, 9, 384, 2, 1),
]


def _inputs(b, h, w, c, d_max, seed):
    rng = np.random.default_rng(seed)
    fm0, fm1 = (rng.random((b, h, w, c), dtype=np.float32) for _ in range(2))
    g = rng.standard_normal((b, (2 * d_max + 1) ** 2, h, w), dtype=np.float32)
    return fm0, fm1, g


def _port_grads(fm0, fm1, g, d_max, stride, dtype):
    a = torch.from_numpy(fm0).to(dtype).requires_grad_()
    b = torch.from_numpy(fm1).to(dtype).requires_grad_()
    out = pointwise_correlation(a, b, d_max, stride, impl="torch", layout="k2hw")
    return torch.autograd.grad(out, (a, b), torch.from_numpy(g))


def _pallas_grads(fm0, fm1, g, d_max, stride, dtype):
    fn = lambda a, b: jax_corr(a, b, d_max, stride, impl="pallas", interpret=True, layout="k2hw")  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(fm0, dtype), jnp.asarray(fm1, dtype))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_corr_grads_match_pallas_f32(case):
    """f32: the Pallas kernels take HIGHEST-precision matmuls, so both sum
    the same f32 products in another order: 1e-5 of the largest magnitude."""
    _, b, h, w, c, d_max, stride = case
    fm0, fm1, g = _inputs(b, h, w, c, d_max, seed=h * w + c)
    got = _port_grads(fm0, fm1, g, d_max, stride, torch.float32)
    ref = _pallas_grads(fm0, fm1, g, d_max, stride, jnp.float32)
    for name, x, r in zip(("dFM0", "dFM1"), got, ref):
        r = np.asarray(r)
        assert x.dtype == torch.float32 and np.isfinite(r).all()
        np.testing.assert_allclose(x.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("h", [8, 44])
def test_corr_grads_match_pallas_bf16(h):
    """bf16 maps give bf16 gradients on both sides. The Pallas backward
    rounds g to bf16 before its matmul and the port keeps g in f32, then
    each rounds its f32 sum to bf16 once: 2e-2 (a few bf16 ulps) of the
    largest magnitude."""
    d_max = 2
    fm0, fm1, g = _inputs(1, h, 7, 8, d_max, seed=h)
    got = _port_grads(fm0, fm1, g, d_max, 1, torch.bfloat16)
    ref = _pallas_grads(fm0, fm1, g, d_max, 1, jnp.bfloat16)
    for name, x, r in zip(("dFM0", "dFM1"), got, ref):
        assert x.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(x.float().numpy(), r, rtol=0, atol=2e-2 * np.abs(r).max(), err_msg=name)
