"""gradients of the port's correlation (autograd through the plain version,
the CPU form of the corr_bwd_fm0 / corr_bwd_fm1 kernels) held against the
JAX package's Pallas backward kernels run in interpret mode, as
tests/test_ops_correlation.py runs them, on the same numpy inputs and the
same cotangent. The cases cover both regimes of the TPU's dFM1 kernels:
`_bwd_fm1_single_tile_kernel` (K3, H <= 40) and the halo'd `_bwd_fm1_kernel`
(K4, H > 40), which the port's one kernel replaces. A replay of the bf16
dFM0 tensor-core kernel's banded algebra is held against both as well."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu.ops.correlation import pointwise_correlation as jax_corr
from detect_to_track_tpu_torch.ops.correlation import corr_bwd_fm0_ref, pointwise_correlation

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


# (name, B, H, W, C, d_max, stride): KS = ceil((15 + 2d) / 16) is 2, 2, 3, 4
# at d 1, 8, 12, 20; W is no multiple of 16; the 5x7 map is smaller than
# the window
BANDED_CASES = [
    ("d1", 1, 7, 21, 8, 1, 1),
    ("d8 stride 2", 1, 11, 19, 5, 8, 2),
    ("d12 stride 3", 1, 13, 35, 4, 12, 3),
    ("d20", 1, 6, 23, 3, 20, 1),
    ("5x7", 1, 5, 7, 6, 8, 1),
    ("C=33", 2, 8, 17, 33, 3, 1),
]


def _window_ok(p, r, d_max, stride, size):
    """correlation_window_masks at position p, displacement r (the kernels'
    window_ok)."""
    src = p + r - d_max
    return r < 2 * d_max and 0 <= src < size and (src - max(0, p - d_max)) % stride == 0


def _banded_fm0(g, fm1, d_max, stride):
    """dFM0 as the bf16 tensor-core kernel builds it (`corr_bwd_mma_kernel`
    with kFm1 = false, ops/csrc/corr_bwd.cu): per output row i, live row
    displacement di (the output row's window mask) and 16 output columns
    from j0, the 16 x 16 KS banded gradient G[m, m + dj] = mask * g[di * k +
    dj, i, j0 + m] (rounded to fm1's dtype, as the kernel rounds its A
    fragments) times FM1's window of row i + di - d, 16 KS columns from
    j0 - d, zero off the map; f32 sums over di, rounded to fm1's dtype once."""
    b, h, w, c = fm1.shape
    k = 2 * d_max + 1
    kk = 16 * -(-(15 + 2 * d_max) // 16)
    g5 = g.to(fm1.dtype).float().reshape(b, k, k, h, w)
    f = fm1.float()
    ok_w = torch.tensor([[_window_ok(j, dj, d_max, stride, w) for dj in range(2 * d_max)] for j in range(w)])
    m, dj = torch.meshgrid(torch.arange(16), torch.arange(2 * d_max), indexing="ij")
    out = torch.zeros(b, h, w, c)
    for i in range(h):
        for di in range(2 * d_max):
            if not _window_ok(i, di, d_max, stride, h):
                continue
            for j0 in range(0, w, 16):
                j = j0 + m
                sel = (j < w) & ok_w[j.clamp(max=w - 1), dj]
                band = torch.zeros(b, 16, kk)
                band[:, m[sel], (m + dj)[sel]] = g5[:, di, dj[sel], i, j[sel]]
                cols = j0 - d_max + torch.arange(kk)
                on = (cols >= 0) & (cols < w)
                window = torch.zeros(b, kk, c)
                window[:, on] = f[:, i + di - d_max, cols[on]]
                n = min(16, w - j0)
                out[:, i, j0:j0 + n] += (band @ window)[:, :n]
    return out.to(fm1.dtype)


@pytest.mark.parametrize("case", BANDED_CASES, ids=lambda c: c[0])
def test_banded_fm0_matches_plain_and_pallas_f32(case):
    """f32: the replay, autograd through the plain version and the Pallas
    `_bwd_fm0_kernel` (HIGHEST precision) sum the same f32 products in
    another order: 1e-5 of the largest magnitude."""
    _, b, h, w, c, d_max, stride = case
    fm0, fm1, g = _inputs(b, h, w, c, d_max, seed=h * w + c + d_max)
    got = _banded_fm0(torch.from_numpy(g), torch.from_numpy(fm1), d_max, stride)
    plain = corr_bwd_fm0_ref(torch.from_numpy(g), torch.from_numpy(fm1), d_max, stride)
    pallas = np.asarray(_pallas_grads(fm0, fm1, g, d_max, stride, jnp.float32)[0])
    scale = np.abs(pallas).max()
    assert got.dtype == torch.float32 and scale > 0
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5 * scale, err_msg="plain")
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-5 * scale, err_msg="pallas")


def test_banded_fm0_matches_pallas_bf16():
    """bf16: the replay and the Pallas kernel both round g to bf16 in the
    band, multiply bf16 maps with f32 sums and round the sum to bf16 once:
    the file's bf16 gate, 2e-2 of the largest magnitude."""
    _, b, h, w, c, d_max, stride = BANDED_CASES[1]
    fm0, fm1, g = _inputs(b, h, w, c, d_max, seed=7)
    got = _banded_fm0(torch.from_numpy(g), torch.from_numpy(fm1).to(torch.bfloat16), d_max, stride)
    ref = _pallas_grads(fm0, fm1, g, d_max, stride, jnp.bfloat16)[0]
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())
