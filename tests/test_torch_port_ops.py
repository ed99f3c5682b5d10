"""the PyTorch port's ops, geometry and config held against the JAX package
on the same numpy inputs (CPU: the port's plain versions; JAX's Pallas
correlation in interpret mode)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu import anchors as j_anchors
from detect_to_track_tpu import boxes as j_boxes
from detect_to_track_tpu import encoding as j_enc
from detect_to_track_tpu import utils as j_utils
from detect_to_track_tpu.config import load_config as j_load_config
from detect_to_track_tpu.ops import lax_ref, nms as j_nms, pooling as j_pool
from detect_to_track_tpu.ops.correlation import pointwise_correlation as j_corr
from detect_to_track_tpu_torch import anchors, boxes, encoding, utils
from detect_to_track_tpu_torch.config import Config, load_config, save_config
from detect_to_track_tpu_torch.ops import correlation, nms, pooling, torch_ref
from tests.test_ops_pooling import ROIS

T = torch.from_numpy


def _rand_boxes(rng, n):
    ij = rng.rand(n, 2).astype(np.float32)
    hw = (rng.rand(n, 2) * 0.5 + 0.01).astype(np.float32)
    return np.concatenate([ij, hw], 1)


# ---------------------------------------------------------------- geometry


def test_boxes_match_jax(rng):
    a, b = _rand_boxes(rng, 40), _rand_boxes(rng, 30)
    b[3] = 0.0  # an empty box: zero union with another empty box
    np.testing.assert_allclose(boxes.ijhw_to_ijij(T(a)).numpy(), np.asarray(j_boxes.ijhw_to_ijij(a)), rtol=1e-6)
    np.testing.assert_allclose(boxes.ijij_to_ijhw(T(a)).numpy(), np.asarray(j_boxes.ijij_to_ijhw(a)), rtol=1e-6)
    np.testing.assert_allclose(boxes.box_areas(T(a)).numpy(), np.asarray(j_boxes.box_areas(a)), rtol=1e-6)
    np.testing.assert_allclose(
        boxes.compute_ious(T(a), T(b)).numpy(), np.asarray(j_boxes.compute_ious(a, b)), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_array_equal(boxes.compute_ious_np(a, b), j_boxes.compute_ious_np(a, b))
    np.testing.assert_array_equal(boxes.ijhw_to_ijij_np(a), j_boxes.ijhw_to_ijij_np(a))
    # batched IoU is the per-frame IoU
    both = boxes.compute_ious(T(np.stack([a, a[::-1].copy()])), T(np.stack([b, b])))
    np.testing.assert_allclose(both[1].numpy(), np.asarray(j_boxes.compute_ious(a[::-1], b)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fm_shape", [(4, 6), 5, (38, 75)])
def test_anchors_match_jax(fm_shape):
    areas, ratios = (0.001, 0.004, 0.016, 0.064, 0.256), (0.5, 1.0, 2.0)
    got = anchors.build_anchors(fm_shape, areas, ratios)
    ref = j_anchors.build_anchors(fm_shape, areas, ratios)
    np.testing.assert_array_equal(got, ref)
    assert not got.flags.writeable
    np.testing.assert_array_equal(
        anchors.build_anchors(fm_shape, areas, ratios, flatten=False),
        j_anchors.build_anchors(fm_shape, areas, ratios, flatten=False),
    )
    np.testing.assert_array_equal(anchors.anchor_boundary_mask(got), j_anchors.anchor_boundary_mask(ref))


def test_box_codec_matches_jax(rng):
    a, b = _rand_boxes(rng, 64), _rand_boxes(rng, 64)
    b[0, 2:] = 0.0  # degenerate target: floored, stays finite
    off = j_enc.frcnn_box_encode(a, b)
    np.testing.assert_allclose(encoding.frcnn_box_encode(T(a), T(b)).numpy(), np.asarray(off), rtol=1e-5, atol=1e-6)
    big = (rng.randn(64, 4) * 6).astype(np.float32)  # beyond the clip
    for clip in (encoding.BBOX_XFORM_CLIP, None):
        np.testing.assert_allclose(
            encoding.frcnn_box_decode(T(a), T(big), clip=clip).numpy(),
            np.asarray(j_enc.frcnn_box_decode(a, big, clip=clip)),
            rtol=1e-5,
            atol=1e-6,
        )
    assert encoding.BBOX_XFORM_CLIP == j_enc.BBOX_XFORM_CLIP
    assert torch.isfinite(encoding.frcnn_box_decode(T(a), T(big * 100))).all()


def test_config_matches_jax(tmp_path):
    for path in ("cfg/default.yaml", "cfg/flagship_608.yaml", None):
        got, ref = load_config(path), j_load_config(path)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        for prop in ("n_anchors", "fm_shape", "max_dets", "pre_nms_topk_eval", "pre_nms_cap_eval",
                     "pre_nms_topk_train", "pre_nms_cap_train", "n_anchors_per_cell"):
            assert getattr(got, prop) == getattr(ref, prop), prop
    cfg = load_config("cfg/default.yaml")
    assert (cfg.pre_nms_topk_eval, cfg.pre_nms_cap_eval, cfg.max_dets, cfg.n_anchors) == (3072, 3000, 128, 42750)
    assert cfg.compute_dtype is torch.bfloat16
    assert Config(COMPUTE_DTYPE="float32").compute_dtype is torch.float32
    with pytest.raises(KeyError):
        load_config(None, NOT_A_KEY=1)
    with pytest.raises(ValueError):
        Config(COMPUTE_DTYPE="bf16")
    with pytest.raises(ValueError):
        Config(INPUT_SHAPE=(600, 1200))
    save_config(cfg, str(tmp_path / "c.yaml"))
    assert load_config(str(tmp_path / "c.yaml")) == cfg


def test_utils_match_jax(rng):
    from PIL import Image

    x = rng.rand(6, 3, 5, 2).astype(np.float32)
    a0, a1 = utils.split_pairs(T(x))
    b0, b1 = j_utils.split_pairs(x)
    np.testing.assert_array_equal(a0.numpy(), b0)
    np.testing.assert_array_equal(a1.numpy(), b1)
    u8 = (rng.rand(4, 5, 3) * 255).astype(np.uint8)
    f32 = rng.rand(4, 5, 3).astype(np.float32)
    for got, ref in zip(utils.promote_mixed_image_dtypes([u8, f32]), j_utils.promote_mixed_image_dtypes([u8, f32])):
        np.testing.assert_array_equal(got, ref)
    tens = utils.promote_mixed_image_dtypes([T(u8), T(f32)])
    np.testing.assert_array_equal(tens[0].numpy(), j_utils.promote_mixed_image_dtypes([u8, f32])[0])
    assert utils.promote_mixed_image_dtypes([u8, u8])[0].dtype == np.uint8
    im = Image.fromarray((rng.rand(30, 40, 3) * 255).astype(np.uint8))
    for as_u8 in (True, False):
        np.testing.assert_array_equal(
            utils.image_to_input(im, (16, 32), as_uint8=as_u8), j_utils.image_to_input(im, (16, 32), as_uint8=as_u8)
        )


def test_resolve_device_never_falls_back():
    assert utils.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert utils.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            utils.resolve_device()
        with pytest.raises(RuntimeError):
            utils.resolve_device("cuda")


# ---------------------------------------------------------- torch_ref vs lax_ref


@pytest.mark.parametrize("clamp", [True, False])
def test_bin_bounds_and_masks_match_lax(clamp, rng):
    rois = np.concatenate([ROIS, _rand_boxes(rng, 20)])
    rois[-1] = [0.5, 0.5, 0.25, 0.25]  # bin edges exactly on pixel boundaries (eps nudge)
    got = torch_ref._bin_bounds(T(rois), 4, 8, 8, clamp)
    ref = lax_ref._bin_bounds(jnp.asarray(rois), 4, 8, 8, clamp)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        torch_ref._range_masks(got[0], got[1], 8).numpy(), np.asarray(lax_ref._range_masks(ref[0], ref[1], 8))
    )


@pytest.mark.parametrize("r_hw", [3, 7])
def test_roi_pool_ref_matches_lax(r_hw, rng):
    fm = rng.randn(11, 10, 6).astype(np.float32)
    got = torch_ref.roi_pool_ref(T(fm), T(ROIS), r_hw).numpy()
    np.testing.assert_allclose(got, np.asarray(lax_ref.roi_pool_ref(fm, ROIS, r_hw)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("paper", [False, True])
def test_ps_roi_pool_ref_matches_lax(paper, rng):
    n_t, k = 3, 3
    np.testing.assert_array_equal(
        torch_ref.ps_roi_pool_channel_map(n_t, k, paper).numpy(),
        np.asarray(lax_ref.ps_roi_pool_channel_map(n_t, k, paper)),
    )
    fm = rng.randn(10, 11, n_t * k * k).astype(np.float32)
    got = torch_ref.ps_roi_pool_ref(T(fm), T(ROIS), n_t, k, paper).numpy()
    ref = lax_ref.ps_roi_pool_ref(fm, ROIS, n_t, k, paper)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d_max", [2, 8])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_correlation_window_masks_match_lax(d_max, stride):
    for size in (5, 17, 38):
        for offset in range(-d_max, d_max + 1):
            np.testing.assert_array_equal(
                torch_ref.correlation_window_masks(size, offset, d_max, stride).numpy(),
                np.asarray(lax_ref.correlation_window_masks(size, offset, d_max, stride)),
            )


@pytest.mark.parametrize("d_max,stride", [(2, 1), (3, 2)])
def test_pointwise_correlation_ref_matches_lax(d_max, stride, rng):
    fm0 = rng.randn(2, 9, 8, 4).astype(np.float32)
    fm1 = rng.randn(2, 9, 8, 4).astype(np.float32)
    got = torch_ref.pointwise_correlation_ref(T(fm0), T(fm1), d_max, stride).numpy()
    ref = lax_ref.pointwise_correlation_ref(fm0, fm1, d_max, stride)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- pooling


@pytest.mark.parametrize("r_hw", [3, 7])
def test_roi_pool_matches_jax(r_hw, rng):
    fm = rng.randn(11, 10, 6).astype(np.float32)
    got = pooling.roi_pool(T(fm), T(ROIS), r_hw).numpy()
    np.testing.assert_allclose(got, np.asarray(j_pool.roi_pool(fm, ROIS, r_hw)), rtol=1e-5, atol=1e-6)
    # a batch of frames is the frames one by one
    fm2 = rng.randn(2, 11, 10, 6).astype(np.float32)
    rois2 = np.stack([ROIS, ROIS[::-1].copy()])
    batched = pooling.roi_pool(T(fm2), T(rois2), r_hw).numpy()
    for f in range(2):
        np.testing.assert_allclose(
            batched[f], np.asarray(j_pool.roi_pool(fm2[f], rois2[f], r_hw)), rtol=1e-5, atol=1e-6
        )


@pytest.mark.parametrize("paper", [False, True])
def test_ps_roi_pool_matches_jax(paper, rng):
    n_t, k = 4, 3
    fm = rng.randn(2, 10, 11, n_t * k * k).astype(np.float32)
    rois = np.stack([ROIS, ROIS[::-1].copy()])
    got = pooling.ps_roi_pool(T(fm), T(rois), n_t, k, paper).numpy()
    for f in range(2):
        ref = j_pool.ps_roi_pool(fm[f], rois[f], n_t, k, paper)
        np.testing.assert_allclose(got[f], np.asarray(ref), rtol=1e-5, atol=1e-6)
    single = pooling.ps_roi_pool(T(fm[0]), T(rois[0]), n_t, k, paper).numpy()
    np.testing.assert_allclose(single, got[0], rtol=1e-6, atol=1e-7)


def test_roi_pool_linear_matches_jax(rng):
    k = 3
    g = rng.randn(2, 9, 10, k, k, 4).astype(np.float32)
    rois = np.stack([ROIS, ROIS[::-1].copy()])
    got = pooling.roi_pool_linear(T(g), T(rois), k).numpy()
    for f in range(2):
        np.testing.assert_allclose(
            got[f], np.asarray(j_pool.roi_pool_linear(g[f], rois[f], k)), rtol=1e-5, atol=1e-5
        )


def test_pooling_errors(rng):
    fm = T(rng.randn(8, 8, 18).astype(np.float32))
    with pytest.raises(ValueError, match="expected 27 channels"):
        pooling.ps_roi_pool(fm, T(ROIS), 3, 3)
    with pytest.raises(NotImplementedError, match="sat"):
        pooling.roi_pool(fm, T(ROIS), 3, impl="sat")
    with pytest.raises(NotImplementedError, match="sat"):
        pooling.ps_roi_pool(fm, T(ROIS), 2, 3, impl="sat")
    with pytest.raises(ValueError, match="unknown impl"):
        pooling.roi_pool(fm, T(ROIS), 3, impl="nope")


# ---------------------------------------------------------------- NMS


def _proposal_inputs(rng, n_frames, n_anchors=5000):
    """clustered boxes (long suppression chains) with tied scores."""
    centers = rng.rand(40, 2)
    pick = rng.randint(0, 40, n_anchors)
    ij = centers[pick] + rng.randn(n_anchors, 2) * 0.02
    hw = rng.rand(n_anchors, 2) * 0.15 + 0.05
    bxs = np.concatenate([ij, hw], 1).astype(np.float32)
    scores = rng.rand(n_frames, n_anchors).astype(np.float32)
    # ties: quantized scores, and exact duplicates across the 3000 cap
    scores = np.round(scores * 200) / 200
    scores[:, :50] = 0.75
    return scores, np.stack([bxs[rng.permutation(n_anchors)] for _ in range(n_frames)])


@pytest.mark.parametrize("max_rois", [256, 128])
def test_proposal_filter_exact_keep_set_at_eval_capacity(max_rois, rng):
    """3072 slots, cap 3000, MAX_ROIS 256 (about 200 survive NMS) or 128
    (the post-NMS cap drops some), tied scores: the same boxes, in the same
    order, as the JAX proposal_filter; the survivors are nms_np's greedy
    keep-set over the same capped candidates."""
    topk, cap, conf, iou = 3072, 3000, 0.3, 0.3
    scores, bxs = _proposal_inputs(rng, 2)
    got = nms.batched_proposal_filter(T(scores), T(bxs), topk, conf, iou, max_rois, cap)
    ref = j_nms.batched_proposal_filter(scores, bxs, topk, conf, iou, max_rois, cap)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(ref.boxes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    for f in range(2):
        gated = np.where(scores[f] > conf, scores[f], -np.inf)
        order = np.argsort(-gated, kind="stable")[:cap]
        assert np.isfinite(gated[order]).all()  # the cap bites: more than 3000 pass the gate
        kept = nms.nms_np(scores[f][order], bxs[f][order], iou)
        np.testing.assert_array_equal(kept, j_nms.nms_np(scores[f][order], bxs[f][order], iou))
        n_valid = int(got.valid[f].sum())
        assert 0 < n_valid <= max_rois
        np.testing.assert_array_equal(got.boxes[f, :n_valid].numpy(), bxs[f][order][kept][:n_valid])
    # one frame alone gives the same result as inside the batch
    one = nms.proposal_filter(T(scores[1]), T(bxs[1]), topk, conf, iou, max_rois, cap)
    np.testing.assert_array_equal(one.boxes.numpy(), got.boxes[1].numpy())


def test_proposal_filter_pads_small_configs(rng):
    scores, bxs = _proposal_inputs(rng, 1, n_anchors=72)
    got = nms.proposal_filter(T(scores[0]), T(bxs[0]), 128, 0.3, 0.3, 100, 72)
    ref = j_nms.proposal_filter(scores[0], bxs[0], 128, 0.3, 0.3, 100, 72)
    assert got.boxes.shape == (100, 4)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_nms_mask_matches_jax(rng):
    bxs = _rand_boxes(rng, 200)
    valid = rng.rand(200) > 0.1
    got = nms.nms_mask(T(bxs), T(valid), 0.2).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_nms.nms_mask(bxs, valid, 0.2)))
    topk = nms.top_k_proposals(T(np.round(rng.rand(300).astype(np.float32), 1)), T(_rand_boxes(rng, 300)), 0.3, 64)
    assert topk.valid.sum() <= 64


# ---------------------------------------------------------------- correlation


@pytest.mark.parametrize("layout", ["nhwkk", "k2hw"])
@pytest.mark.parametrize("c", [5, 384])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("d_max", [2, 8])
def test_correlation_plain_matches_pallas_and_lax(d_max, stride, c, layout, rng):
    """f32, single row tile (H <= 40): rtol 1e-4 / atol 1e-5 as the JAX
    package's own Pallas-vs-oracle test, atol scaled by sqrt(C) for the
    longer sums at C=384."""
    h, w = (10, 11) if d_max == 2 else (12, 19)
    fm0 = rng.rand(2, h, w, c).astype(np.float32)
    fm1 = rng.rand(2, h, w, c).astype(np.float32)
    got = correlation.pointwise_correlation(T(fm0), T(fm1), d_max, stride, impl="torch", layout=layout)
    auto = correlation.pointwise_correlation(T(fm0), T(fm1), d_max, stride, layout=layout)
    torch.testing.assert_close(auto, got, rtol=0, atol=0)  # CPU tensors -> plain version
    pallas = j_corr(fm0, fm1, d_max, stride, impl="pallas", interpret=True, layout=layout)
    ref = j_corr(fm0, fm1, d_max, stride, impl="xla", layout=layout)
    tol = dict(rtol=1e-4, atol=1e-5 * np.sqrt(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    k = 2 * d_max + 1
    assert got.shape == ((2, h, w, k, k) if layout == "nhwkk" else (2, k * k, h, w))


@pytest.mark.parametrize("d_max", [2, 8])
def test_correlation_bf16(d_max, rng):
    """bf16 maps: the port sums exact products of the bf16 values in f32,
    so it equals the f32 plain version on the bf16-cast inputs (to f32
    rounding). The Pallas kernel rounds each product matrix to bf16 before
    it extracts the diagonals, so it is held to 4 bf16 ulps (4 * 2^-8)
    of the largest magnitude."""
    h, w, c = 12, 19, 64
    a = jnp.asarray(rng.rand(1, h, w, c).astype(np.float32), jnp.bfloat16)
    b = jnp.asarray(rng.rand(1, h, w, c).astype(np.float32), jnp.bfloat16)
    a32, b32 = np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32))
    t0, t1 = T(a32.copy()).to(torch.bfloat16), T(b32.copy()).to(torch.bfloat16)
    got = correlation.pointwise_correlation(t0, t1, d_max, impl="torch")
    assert got.dtype == torch.float32
    f32 = correlation.pointwise_correlation(T(a32.copy()), T(b32.copy()), d_max, impl="torch")
    torch.testing.assert_close(got, f32, rtol=1e-6, atol=1e-6)
    pallas = np.asarray(j_corr(a, b, d_max, 1, impl="pallas", interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=4 * 2.0**-8 * np.abs(pallas).max())


def test_correlation_errors(rng):
    fm = T(rng.rand(1, 6, 6, 3).astype(np.float32))
    with pytest.raises(ValueError, match="dtype mismatch"):
        correlation.pointwise_correlation(fm, fm.double(), 2)
    with pytest.raises(ValueError, match="unknown layout"):
        correlation.pointwise_correlation(fm, fm, 2, layout="nchw")
    with pytest.raises(ValueError, match="unknown impl"):
        correlation.pointwise_correlation(fm, fm, 2, impl="xla")
    launches = correlation.corr_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        correlation.pointwise_correlation(fm, fm, 2, impl="cuda")
    assert correlation.corr_fwd_cuda.launches == launches  # nothing launched
    # the backward kernels take CUDA tensors only, and count no launch otherwise
    bwd = (correlation.corr_bwd_fm0_cuda, correlation.corr_bwd_fm1_cuda)
    counts = [fn.launches for fn in bwd]
    for fn in bwd:
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(torch.zeros(1, 25, 6, 6), fm, 2, 1)
    assert [fn.launches for fn in bwd] == counts


@pytest.mark.parametrize("c, offset", [(5, 0), (16, 0), (16, 1)])
def test_tensor_core_map_layout(c, offset):
    """the bf16 maps the tensor-core kernels stage: C zero-padded to whole
    16-byte units and 16-byte aligned, values unchanged; an aligned map of
    whole units passes through without a copy."""
    flat = torch.arange(2 * 3 * 4 * c + offset, dtype=torch.float32).to(torch.bfloat16)
    fm = flat[offset:].view(2, 3, 4, c)  # offset 1: 2 bytes off alignment
    got = correlation._tensor_core_map(fm)
    assert got.is_contiguous() and got.shape[-1] % 8 == 0 and got.data_ptr() % 16 == 0
    assert torch.equal(got[..., :c], fm) and not got[..., c:].any()
    assert (got is fm) == (c % 8 == 0 and offset == 0)
