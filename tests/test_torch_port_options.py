"""the configuration options the port took last, each held against its JAX
counterpart (run as the JAX package's own tests run it) and against the
port's plain path, in float32 on the CPU:

- HOST_S2D: `utils.space_to_depth2`, the backbone's pre-s2d stem, the
  Detector, ClipTracker and BatchLoader (tolerances of
  tests/test_torch_port_detect.py and tests/test_torch_port_clip.py);
- REMAT: the training step with checkpointed bottlenecks against JAX's
  REMAT step (tests/test_parallel.py's step tolerances) and, bitwise,
  against the port's plain step;
- `roi_pool` / `ps_roi_pool` with impl="sat" and their gradients (the
  cases of tests/test_ops_pooling.py);
- `diagnostics.checked_loss_fn`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu import trainer as jtrainer
from detect_to_track_tpu import utils as jutils
from detect_to_track_tpu.clip import ClipTracker as JaxClipTracker
from detect_to_track_tpu.config import Config as JaxConfig
from detect_to_track_tpu.diagnostics import checked_loss_fn as jax_checked_loss_fn
from detect_to_track_tpu.inference import Detector as JaxDetector
from detect_to_track_tpu.losses import DTLoss as JaxDTLoss
from detect_to_track_tpu.models import DetectTrackModule as JaxDetectTrack
from detect_to_track_tpu.models.convert import convert_reference_state_dict
from detect_to_track_tpu.ops import pooling as jpool
from detect_to_track_tpu_torch import trainer, utils
from detect_to_track_tpu_torch.clip import ClipTracker
from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
from detect_to_track_tpu_torch.diagnostics import checked_loss_fn
from detect_to_track_tpu_torch.inference import Detector
from detect_to_track_tpu_torch.losses import DTLoss
from detect_to_track_tpu_torch.models import DetectTrackModule, resnet
from detect_to_track_tpu_torch.models.convert import from_jax_params, load_reference_state_dict
from detect_to_track_tpu_torch.ops import pooling
from tests.test_full_graph_parity import ARCH, D_MAX, HW, K, N_ANCHORS, N_CLASSES, _full_reference_state_dict
from tests.test_torch_port_clip import HEAD_SCALES, _assert_same_tubelets
from tests.test_torch_port_detect import CFG_KW, TOL, _assert_same_rows, _trim
from tests.test_torch_port_parallel import DP, LOSS_TOL, PARAM_TOL

T = torch.from_numpy
ROIS = np.array(  # tests/test_ops_pooling.py's rois
    [
        [0.5, 0.5, 0.6, 0.6],
        [0.3, 0.4, 0.2, 0.5],
        [0.7, 0.6, 0.5, 0.3],
        [0.1, 0.1, 0.3, 0.3],
        [0.95, 0.95, 0.2, 0.2],
    ],
    np.float32,
)

# ------------------------------------------------------------- HOST_S2D


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_space_to_depth2_matches_jax(dtype, rng):
    x = (rng.rand(2, 3, 6, 8, 3) * 255).astype(dtype)
    got = utils.space_to_depth2(x)
    ref = jutils.space_to_depth2(x)
    assert got.dtype == ref.dtype == dtype and got.shape == (2, 3, 3, 4, 12)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0, 1, 2, 1 * 6 + 0 * 3 + 2] == x[0, 0, 3, 4, 2]  # z[a, b, vi*6+vj*3+c] = x[2a+vi, 2b+vj, c]
    with pytest.raises(ValueError, match="even HxW"):
        utils.space_to_depth2(x[..., :5, :, :])


@pytest.fixture(scope="module")
def s2d_detectors():
    """(jax HOST_S2D detector, port HOST_S2D detector, port plain detector)
    on one reference-keyed state_dict with tests/test_torch_port_clip.py's
    head scales."""
    sd = _full_reference_state_dict()
    for name, scale in HEAD_SCALES.items():
        for k in (f"{name}.weight", f"{name}.bias"):
            sd[k] = sd[k] * scale
    jmodel = JaxDetectTrack(
        backbone_arch=ARCH, n_anchors=N_ANCHORS, n_classes=N_CLASSES, k=K, d_max=D_MAX, r_hw=K, dtype=jnp.float32
    )
    jdet = JaxDetector(jmodel, {"params": convert_reference_state_dict(sd, ARCH)}, JaxConfig(**CFG_KW, HOST_S2D=True))
    cfg = Config(**CFG_KW, HOST_S2D=True)
    port = DetectTrackModule.from_config(cfg, device="cpu")
    port.load_state_dict(load_reference_state_dict(sd))
    return jdet, Detector(port, cfg, device="cpu"), Detector(port, Config(**CFG_KW), device="cpu")


def _frames(seed, n):
    return (np.random.RandomState(seed).rand(n, *HW, 3) * 255).astype(np.uint8)


def test_s2d_backbone_matches_jax_and_plain_stem(s2d_detectors):
    """the 12-channel stem on space_to_depth2 frames: against the JAX
    backbone on the same packed frames, and against the port's own 7x7/s2
    stem on the unpacked frames (the same function, summed in another
    order)."""
    jdet, det, _ = s2d_detectors
    x = np.random.RandomState(0).rand(2, *HW, 3).astype(np.float32)
    z = utils.space_to_depth2(x)
    ref = jdet.model.apply(jdet.variables, jnp.asarray(z), method="backbone")
    with torch.no_grad():
        got = det.model.backbone(T(z))
        plain = det.model.backbone(T(x))
    for key in ("c3", "c4", "c5"):
        scale = float(np.abs(np.asarray(ref[key])).max())
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-5 * scale, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), plain[key].numpy(), rtol=1e-4, atol=1e-5 * scale, err_msg=key)
    w = det.model.backbone.conv1.weight
    assert resnet.s2d_stem_weight(w).shape == (64, 12, 4, 4)
    with pytest.raises(ValueError, match="12"):
        det.model.backbone(torch.zeros(1, 8, 8, 4))


def test_host_s2d_detector_matches_jax_and_plain(s2d_detectors):
    jdet, det, plain = s2d_detectors
    frames = _frames(3, 2)
    got, ref, base = det(frames[0], frames[1]), jdet(frames[0], frames[1]), plain(frames[0], frames[1])
    for other, name in ((ref, "jax"), (base, "plain stem")):
        _assert_same_rows((got[0], got[2], got[4]), (other[0], other[2], other[4]), f"{name} frame0")
        _assert_same_rows((got[1], got[3], None), (other[1], other[3], None), f"{name} frame1")
    pairs = np.stack([_frames(4, 2), _frames(5, 2)])
    got, ref = det.detect_pairs(pairs), jdet.detect_pairs(pairs)
    for p in range(2):
        g = _trim(*(f[p].numpy() for f in got))
        r = _trim(*(np.asarray(f[p]) for f in ref))
        _assert_same_rows(g[0], r[0], f"pair{p} frame0")
        _assert_same_rows(g[1], r[1], f"pair{p} frame1")
    # host frames are packed once; packed frames pass; a 3-channel tensor is refused
    packed = det.detect_pairs(utils.space_to_depth2(pairs))
    torch.testing.assert_close(packed.boxes, got.boxes, rtol=0, atol=0)
    with pytest.raises(ValueError, match="3-channel tensor"):
        det.detect_pairs(torch.from_numpy(pairs))


def test_host_s2d_clip_tracker_matches_jax_and_plain(s2d_detectors):
    jdet, det, plain = s2d_detectors
    frames = list(_frames(11, 5))
    kw = dict(link_iou_thresh=0.5, min_len=1, frame_chunk=3)
    got = ClipTracker(det, **kw)(frames)
    _assert_same_tubelets(got, JaxClipTracker(jdet, **kw)(frames))
    _assert_same_tubelets(got, ClipTracker(plain, **kw)(frames))


def test_host_s2d_batch_loader_matches_jax():
    kw = dict(CFG_KW, HOST_S2D=True, MAX_LABELS=8, LOADER_WORKERS=1)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    manager = SyntheticVIDManager(4, cfg.INPUT_SHAPE, n_classes=N_CLASSES)
    from detect_to_track_tpu.data.synthetic import SyntheticVIDManager as JaxSynthetic

    got = next(iter(trainer.BatchLoader(manager, 2, cfg, seed=3)))
    ref = next(iter(jtrainer.BatchLoader(JaxSynthetic(4, jcfg.INPUT_SHAPE, n_classes=N_CLASSES), 2, jcfg, seed=3)))
    assert got.images.shape == (2, 2, HW[0] // 2, HW[1] // 2, 12)
    np.testing.assert_array_equal(got.images, ref.images)
    for a, b in zip(got.labels, ref.labels):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- REMAT


@pytest.fixture(scope="module")
def remat_steps():
    """one step on tests/test_parallel.py's configuration with REMAT: the
    JAX package's, the port's, and the port's plain step, from the same
    JAX-initialised weights and batch."""
    cfg = Config(**DP, REMAT=True)
    jcfg = JaxConfig(**DP, REMAT=True)
    jmodel = JaxDetectTrack.from_config(jcfg, corr_impl="xla")
    h, w = cfg.INPUT_SHAPE
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, h, w, 3), jnp.float32), jnp.full((2, cfg.MAX_ROIS, 4), 0.4, jnp.float32)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    batch = next(iter(trainer.BatchLoader(SyntheticVIDManager(4, cfg.INPUT_SHAPE, n_classes=4, n_objects=2), 4, cfg)))
    tx = jtrainer.make_optimizer(jcfg, params)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state, dtl = jtrainer.make_train_step(jmodel, jcfg, tx)(
        jtrainer.TrainState(params=p, opt_state=tx.init(p), step=jnp.zeros((), jnp.int32)), batch
    )
    jdtl = jax.device_get(dtl)
    ref = (np.array([jdtl.o, jdtl.b_rpn, jdtl.c, jdtl.b_rcnn, jdtl.t], np.float32),
           from_jax_params(jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))))

    def port_step(c):
        model = DetectTrackModule.from_config(c, device="cpu")
        model.load_state_dict(from_jax_params(params))
        losses = trainer.make_train_step(model, c, trainer.make_optimizer(c, model), device="cpu")(batch).vector()
        return losses, dict(model.named_parameters())

    calls = []
    checkpoint = resnet.checkpoint
    resnet.checkpoint = lambda fn, *a, **kw: calls.append(fn) or checkpoint(fn, *a, **kw)
    try:
        remat = port_step(cfg)
    finally:
        resnet.checkpoint = checkpoint
    return ref, remat, port_step(Config(**DP)), len(calls)


def test_remat_step_matches_jax_remat_step(remat_steps):
    (ref_losses, ref_params), (losses, params), _, n_checkpointed = remat_steps
    # the bottlenecks of the trainable stages 3 and 4 of ResNet-50 (6 + 3)
    assert n_checkpointed == 9
    np.testing.assert_allclose(losses.numpy(), ref_losses, **LOSS_TOL)
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref_params[name]), err_msg=name, **PARAM_TOL)


def test_remat_step_equals_plain_step(remat_steps):
    """recomputing the activations changes no number."""
    _, (losses, params), (plain_losses, plain_params), _ = remat_steps
    torch.testing.assert_close(losses, plain_losses, rtol=0, atol=0)
    moved = 0
    for name, p in params.items():
        torch.testing.assert_close(p, plain_params[name], rtol=0, atol=0, msg=name)
        moved += p.requires_grad
    assert moved > 10


# ------------------------------------------------------------- sat pooling


@pytest.mark.parametrize("r_hw", [5, 7])
def test_roi_pool_sat_matches_jax(r_hw, rng):
    fm = rng.rand(13, 17, 8).astype(np.float32)
    got = pooling.roi_pool(T(fm), T(ROIS), r_hw, impl="sat").numpy()
    np.testing.assert_allclose(got, np.asarray(jpool.roi_pool(fm, ROIS, r_hw, "sat")), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, pooling.roi_pool(T(fm), T(ROIS), r_hw).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_targets", [1, 3])
@pytest.mark.parametrize("paper", [False, True])
def test_ps_roi_pool_sat_matches_jax(n_targets, paper, rng):
    r_hw = 7
    fm = rng.rand(12, 19, n_targets * r_hw**2).astype(np.float32)
    got = pooling.ps_roi_pool(T(fm), T(ROIS), n_targets, r_hw, paper, impl="sat").numpy()
    ref = np.asarray(jpool.ps_roi_pool(fm, ROIS, n_targets, r_hw, paper, "sat"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, pooling.ps_roi_pool(T(fm), T(ROIS), n_targets, r_hw, paper).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_sat_pooling_batched_and_out_of_bounds(rng):
    """a frame batch pools each frame; a roi outside the map pools to 0."""
    fm = rng.rand(2, 10, 11, 2 * 9).astype(np.float32)
    rois = np.stack([ROIS, ROIS[::-1].copy()])
    for f in range(2):
        np.testing.assert_allclose(pooling.ps_roi_pool(T(fm), T(rois), 2, 3, impl="sat")[f].numpy(),
                                   pooling.ps_roi_pool(T(fm[f]), T(rois[f]), 2, 3, impl="sat").numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(pooling.roi_pool(T(fm), T(rois), 3, impl="sat")[f].numpy(),
                                   pooling.roi_pool(T(fm[f]), T(rois[f]), 3, impl="sat").numpy(), rtol=0, atol=0)
    oob = T(np.array([[3.0, 3.0, 0.5, 0.5]], np.float32))
    assert not pooling.ps_roi_pool(T(np.full((10, 10, 18), 10.0, np.float32)), oob, 2, 3, impl="sat").any()
    assert torch.isfinite(pooling.roi_pool(T(fm[0]), oob, 5, impl="sat")).all()


def test_sat_pooling_gradients_match_jax(rng):
    """tests/test_ops_pooling.py::test_roi_pool_sat_grad_matches_ref_grad,
    against the JAX sat gradient, for both poolings; and a float64
    finite-difference check."""
    fm = rng.rand(9, 12, 4).astype(np.float32)
    ref = jax.grad(lambda f: (jpool.roi_pool(f, ROIS, 5, "sat") ** 2).sum())(fm)
    x = T(fm).requires_grad_()
    (pooling.roi_pool(x, T(ROIS), 5, impl="sat") ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)
    fmp = rng.rand(10, 11, 2 * 36).astype(np.float32)
    ref = jax.grad(lambda f: (jpool.ps_roi_pool(f, ROIS[:3], 2, 6, False, "sat") ** 2).sum())(fmp)
    x = T(fmp).requires_grad_()
    (pooling.ps_roi_pool(x, T(ROIS[:3]), 2, 6, impl="sat") ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)
    rois64 = T(ROIS[:2].astype(np.float64))
    assert torch.autograd.gradcheck(
        lambda f: pooling.roi_pool(f, rois64, 5, impl="sat").sum(), (torch.rand(10, 11, 2, dtype=torch.float64,
                                                                               requires_grad=True),))
    assert torch.autograd.gradcheck(
        lambda f: pooling.ps_roi_pool(f, rois64, 2, 3, impl="sat").sum(),
        (torch.rand(10, 11, 18, dtype=torch.float64, requires_grad=True),))


# ------------------------------------------------------------- diagnostics


@pytest.mark.parametrize("bad", [None, 0, 1, 2, 3, 4])
def test_checked_loss_fn_matches_jax(bad):
    """finite losses pass; a NaN or inf component is named as JAX's
    checkify names it."""
    vals = [0.5, 1.0, 2.0, 3.0, 4.0]
    if bad is not None:
        vals[bad] = float("nan") if bad % 2 else float("inf")
    err, dtl = checked_loss_fn(lambda p, b: DTLoss.single(*(torch.tensor(v) for v in vals)))(None, None)
    jerr, _ = jax_checked_loss_fn(lambda p, b: JaxDTLoss.single(*(jnp.asarray(v) for v in vals)))(None, None)
    assert float(dtl.o) == vals[0]
    if bad is None:
        assert err.get() is None and jerr.get() is None
        err.throw()
        return
    name = "oacrt"[bad]
    assert err.get() == f"loss component '{name}' is non-finite"
    assert err.get() in jerr.get()
    with pytest.raises(FloatingPointError, match=f"'{name}'"):
        err.throw()
