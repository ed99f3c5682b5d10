"""the port's losses, label encoders and data types held against the JAX
package's on the same numpy inputs, in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu import encoding as jenc
from detect_to_track_tpu import losses as jlosses
from detect_to_track_tpu.anchors import anchor_boundary_mask, build_anchors
from detect_to_track_tpu.data.synthetic import SyntheticVIDManager as JaxSynthetic
from detect_to_track_tpu.data.types import ObjectLabel as JaxLabel
from detect_to_track_tpu.data.types import pack_labels as jax_pack_labels
from detect_to_track_tpu_torch import encoding, losses
from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
from detect_to_track_tpu_torch.data.types import ObjectLabel, pack_labels

T = torch.from_numpy


def _close(got, ref, name, rtol=1e-6, atol=1e-6):
    """elementwise f32 ops in the same order: a few ulps."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, err_msg=name)


def _probs(rng, shape, with_edges=True):
    """softmaxed scores; with_edges puts exact 0 and 1 probabilities in."""
    x = rng.standard_normal(shape).astype(np.float32) * 3
    p = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    if with_edges:
        p[0] = 0.0
        p[0, 0] = 1.0
        p[1, -1] = 1.0
        p[1, :-1] = 0.0
    return p.astype(np.float32)


def test_safe_log_and_bce_nan_free_at_zero():
    """log clamped at -100, and the gradient at p = 0 and p = 1 is finite
    (JAX's _safe_log keeps it so; a bare where(log) gives NaN)."""
    p = np.array([0.0, 1e-45, 1e-40, 2e-39, 1.2e-38, 1e-20, 0.3, 1.0], np.float32)
    y = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    _close(losses._safe_log(T(p)), jlosses._safe_log(jnp.asarray(p)), "safe_log")
    pt = T(p).requires_grad_()
    out = losses._bce(pt, T(y))
    out.sum().backward()
    ref_out, ref_grad = jax.value_and_grad(lambda q: jlosses._bce(q, jnp.asarray(y)).sum())(jnp.asarray(p))
    _close(out.sum(), ref_out, "bce")
    assert torch.isfinite(pt.grad).all()
    _close(pt.grad, ref_grad, "bce grad", rtol=1e-5)


def test_focal_loss_gradient_finite_on_saturated_softmax():
    """logits 100 apart: the softmax gives subnormal probabilities (~1e-44),
    whose 1/p overflows. They count as 0 in _safe_log, as the JAX package's
    flushed subnormals do, so the gradient stays finite and equal."""
    logits = np.array([[0.0, 100.0], [95.0, 0.0], [0.0, 0.0]], np.float32)
    c_star = np.array([0, 1, 1])
    x = T(logits).requires_grad_()
    loss = losses.focal_loss(torch.softmax(x, -1), T(c_star)).sum()
    loss.backward()
    ref, ref_grad = jax.value_and_grad(
        lambda z: jlosses.focal_loss(jax.nn.softmax(z, -1), jnp.asarray(c_star)).sum()
    )(jnp.asarray(logits))
    assert torch.isfinite(x.grad).all()
    _close(loss, ref, "focal", rtol=1e-5)
    _close(x.grad, ref_grad, "focal grad", rtol=1e-5)


@pytest.mark.parametrize("gamma", [2.0, 1.0])
def test_focal_loss_matches_jax(rng, gamma):
    c_hat = _probs(rng, (6, 5))
    c_star = rng.randint(0, 5, 6)
    got_in = T(c_hat).requires_grad_()
    got = losses.focal_loss(got_in, T(c_star), 0.25, gamma)
    ref, vjp = jax.vjp(lambda c: jlosses.focal_loss(c, jnp.asarray(c_star), 0.25, gamma), jnp.asarray(c_hat))
    _close(got, ref, "focal")
    cot = rng.standard_normal(6).astype(np.float32)
    got.backward(T(cot))
    assert torch.isfinite(got_in.grad).all()
    _close(got_in.grad, vjp(jnp.asarray(cot))[0], "focal grad", rtol=1e-5)


def test_box_losses_match_jax(rng):
    b_hat = rng.standard_normal((7, 4)).astype(np.float32) * 2
    b_star = rng.standard_normal((7, 4)).astype(np.float32)
    b_star[0] = b_hat[0] + 1.0  # exactly at the smooth-L1 kink
    c_star = np.array([0, 1, 2, 0, 3, 1, 0])
    _close(losses.smooth_l1(T(b_hat), T(b_star)), jlosses.smooth_l1(jnp.asarray(b_hat), jnp.asarray(b_star)), "sl1")
    _close(
        losses.bbox_loss(T(b_hat), T(b_star), T(c_star)),
        jlosses.bbox_loss(jnp.asarray(b_hat), jnp.asarray(b_star), jnp.asarray(c_star)),
        "bbox",
    )


def test_rpn_loss_matches_jax(rng):
    b, a = 2, 30
    lw = (rng.rand(b, a) > 0.3).astype(np.float32)
    o_hat = _probs(rng, (b, a, 2))
    o_star = rng.randint(0, 2, (b, a))
    b_hat = rng.standard_normal((b, a, 4)).astype(np.float32)
    b_star = rng.standard_normal((b, a, 4)).astype(np.float32)
    args = (lw, o_hat, o_star, b_hat, b_star)
    got = losses.rpn_loss(*map(T, args), 0.25, 2.0)
    ref = jlosses.rpn_loss(*map(jnp.asarray, args), 0.25, 2.0)
    for g, r, name in zip(got, ref, ("o", "b")):
        _close(g, r, name)


@pytest.mark.parametrize("n_valid", [0, 1, 9])
def test_rcnn_and_track_losses_match_jax(rng, n_valid):
    """masked means, including an empty mask (0, not NaN) and NaN garbage in
    padding slots; the port's versions also take leading instance axes."""
    n, c = 9, 4
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    c_hat = _probs(rng, (n, c))
    c_star = rng.randint(0, c, n)
    b_hat = rng.standard_normal((n, 4)).astype(np.float32)
    b_star = rng.standard_normal((n, 4)).astype(np.float32)
    b_star[~valid] = np.nan
    got = losses.rcnn_loss(T(c_hat), T(c_star), T(b_hat), T(b_star), T(valid), 0.25, 2.0)
    ref = jlosses.rcnn_loss(*map(jnp.asarray, (c_hat, c_star, b_hat, b_star, valid)), 0.25, 2.0)
    for g, r, name in zip(got, ref, ("c", "b")):
        _close(g, r, name)
        assert np.isfinite(float(g))
    got_t = losses.track_loss(T(b_hat), T(b_star), T(valid))
    _close(got_t, jlosses.track_loss(jnp.asarray(b_hat), jnp.asarray(b_star), jnp.asarray(valid)), "t")
    # two instances at once: each its own masked mean
    stack = lambda a: T(np.stack([a, a[::-1].copy()]))  # noqa: E731
    both = losses.track_loss(stack(b_hat), stack(b_star), stack(valid))
    assert both.shape == (2,)
    _close(both[0], got_t, "t batched")


def test_dtloss_matches_jax():
    vals = [0.5, 0.25, 1.5, 0.125, 3.0]
    got = losses.DTLoss.single(*map(torch.tensor, vals))
    ref = jlosses.DTLoss.single(*map(jnp.asarray, vals))
    total, ref_total = got + got, ref + ref
    coefs = (1.0, 1.0, 1.0, 1.0, 1e-4)
    _close(total.to_scalar(coefs), ref_total.to_scalar(jnp.asarray(coefs)), "to_scalar")
    _close(total.to_scalar(), ref_total.to_scalar(), "to_scalar ones")
    assert float(total.count) == 2.0
    assert set(total.asdict()) == set(ref_total.asdict()) == {"o", "a", "c", "r", "t"}
    assert repr(total) == repr(ref_total)
    assert float(losses.DTLoss().to_scalar()) == float(jlosses.DTLoss().to_scalar()) == 0.0


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

FM, AREAS, RATIOS = (4, 6), (0.02, 0.08), (0.5, 1.0, 2.0)


def _labels(rng, n, cap, n_valid):
    """padded labels, real ones first, with a degenerate box (h = 0), a tie
    (a duplicated box) and duplicate track ids."""
    boxes = np.zeros((n, cap, 4), np.float32)
    classes = np.zeros((n, cap), np.int32)
    tids = np.full((n, cap), -1, np.int32)
    mask = np.zeros((n, cap), bool)
    for f in range(n):
        k = n_valid[f]
        ij = rng.rand(k, 2) * 0.6 + 0.2
        hw = rng.rand(k, 2) * 0.4 + 0.05
        boxes[f, :k] = np.concatenate([ij, hw], -1)
        classes[f, :k] = rng.randint(1, 4, k)
        tids[f, :k] = rng.randint(0, 3, k)
        mask[f, :k] = True
        if k >= 3:
            boxes[f, 1, 2] = 0.0  # degenerate
            boxes[f, 2] = boxes[f, 0]  # a tie with label 0
    return boxes, classes, tids, mask


def _anchors():
    a = np.array(build_anchors(FM, AREAS, RATIOS))
    return a, anchor_boundary_mask(a)


def test_anchor_encode_matches_jax(rng):
    anchors, crosses = _anchors()
    boxes, classes, _, mask = _labels(rng, 4, 6, [5, 0, 1, 3])
    got = encoding.anchor_encode(T(anchors), T(crosses), T(boxes), T(classes), T(mask), 0.5, 0.2)
    ref = jax.vmap(lambda b, c, m: jenc.anchor_encode(jnp.asarray(anchors), jnp.asarray(crosses), b, c, m, 0.5, 0.2))(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(mask)
    )
    np.testing.assert_array_equal(got.loss_weights.numpy(), np.asarray(ref.loss_weights))
    np.testing.assert_array_equal(got.c_star.numpy(), np.asarray(ref.c_star))
    assert got.c_star.dtype == torch.int32
    _close(got.b_star, ref.b_star, "b_star", atol=1e-5)
    assert (got.c_star[0] > 0).any() and (got.c_star[1] == 0).all()
    assert (got.b_star[1] == 0).all()  # no labels: zeros


def test_argmax_takes_the_first_maximum():
    """ties between labels go to the lower index, as numpy and JAX order
    them: two identical boxes with different classes."""
    anchors, crosses = _anchors()
    box = anchors[9].copy()
    boxes = np.stack([box, box, np.zeros(4, np.float32)])[None]
    classes = np.array([[2, 3, 0]], np.int32)
    mask = np.array([[True, True, False]])
    got = encoding.anchor_encode(T(anchors), T(crosses), T(boxes), T(classes), T(mask))
    assert got.c_star[0, 9] == 2
    ref = jenc.anchor_encode(*map(jnp.asarray, (anchors, crosses, boxes[0], classes[0], mask[0])))
    np.testing.assert_array_equal(got.c_star[0].numpy(), np.asarray(ref.c_star))


@pytest.mark.parametrize("fix", [False, True])
def test_region_encode_matches_jax(rng, fix):
    boxes, classes, _, mask = _labels(rng, 3, 6, [4, 0, 2])
    regions = np.concatenate([rng.rand(3, 10, 2) * 0.6 + 0.2, rng.rand(3, 10, 2) * 0.4 + 0.05], -1).astype(np.float32)
    regions[:, -2:] = 0.0  # padding rows
    regions[0, 0] = boxes[0, 0]  # IoU exactly 1
    got = encoding.region_encode(T(regions), T(boxes), T(classes), T(mask), 0.5, fix)
    ref = jax.vmap(lambda r, b, c, m: jenc.region_encode(r, b, c, m, 0.5, fix))(
        *map(jnp.asarray, (regions, boxes, classes, mask))
    )
    np.testing.assert_array_equal(got.c_star.numpy(), np.asarray(ref.c_star))
    valid_rows = np.isfinite(np.asarray(ref.b_star))
    _close(got.b_star.numpy()[valid_rows], np.asarray(ref.b_star)[valid_rows], "b_star", atol=1e-5)
    assert (got.b_star[1] == 0).all()
    assert (got.c_star[0, 0] > 0) == fix


def test_track_encode_matches_jax(rng):
    b0, c0, t0, m0 = _labels(rng, 3, 6, [5, 4, 0])
    b1, c1, t1, m1 = _labels(rng, 3, 6, [5, 0, 3])
    # frame 1 repeats frame 0's objects, moved, with one duplicate pair
    b1[0, :5] = b0[0, :5] + 0.01
    b1[0, :5, 2:] = np.maximum(b1[0, :5, 2:], 0.02)
    c1[0], t1[0] = c0[0], t0[0]
    c0[0, 3], t0[0, 3] = c0[0, 0], t0[0, 0]  # duplicate pair in frame 0
    args = (b0, c0, t0, m0, b1, c1, t1, m1)
    got = encoding.track_encode(*map(T, args))
    ref = jax.vmap(jenc.track_encode)(*map(jnp.asarray, args))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    _close(got.rois, ref.rois, "rois")
    _close(got.t_star, ref.t_star, "t_star", atol=1e-5)
    assert got.valid[0].any() and not got.valid[2].any()
    assert not got.valid[0, 0]  # the later duplicate wins


def test_track_encode_np_matches_jax(rng):
    mk = lambda cls, labels: [cls(c, f"c{c}", tuple(b), t) for c, b, t in labels]  # noqa: E731
    lab0 = [(1, (0.5, 0.5, 0.2, 0.2), 0), (2, (0.3, 0.4, 0.1, 0.3), 1), (1, (0.6, 0.6, 0.2, 0.1), 0)]
    lab1 = [(1, (0.52, 0.5, 0.2, 0.25), 0), (3, (0.3, 0.4, 0.1, 0.3), 1)]
    got = encoding.track_encode_np(mk(ObjectLabel, lab0), mk(ObjectLabel, lab1))
    ref = jenc.track_encode_np(mk(JaxLabel, lab0), mk(JaxLabel, lab1))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12)
    assert got[0].shape == (1, 4)


def test_pack_labels_and_synthetic_match_jax():
    port = SyntheticVIDManager(n_samples=3, image_hw=(32, 48), n_objects=4, n_classes=6, seed=2)
    ref = JaxSynthetic(n_samples=3, image_hw=(32, 48), n_objects=4, n_classes=6, seed=2)
    assert len(port) == len(ref) == 3
    for i in range(3):
        for got, want in zip(port[i], ref[i]):
            np.testing.assert_array_equal(got.im, want.im)
            assert [tuple(lb) for lb in got.labels] == [tuple(lb) for lb in want.labels]
            for cap in (2, 8):
                for a, b in zip(pack_labels(got.labels, cap), jax_pack_labels(want.labels, cap)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    none_tid = [ObjectLabel(1, "a", (0.5, 0.5, 0.1, 0.1))]
    assert pack_labels(none_tid, 3).track_ids.tolist() == [-1, -1, -1]
