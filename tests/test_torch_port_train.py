"""the port's joint training step held against the JAX package's on the same
weights (JAX init params through `from_jax_params`) and the same synthetic
batch, in float32 on the CPU, at the small configuration of
tests/test_train_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu import trainer as jtrainer
from detect_to_track_tpu.config import Config as JaxConfig
from detect_to_track_tpu.data.synthetic import SyntheticVIDManager as JaxSynthetic
from detect_to_track_tpu.losses import track_loss as jax_track_loss
from detect_to_track_tpu.models import DetectTrackModule as JaxDetectTrack
from detect_to_track_tpu.models import resnet_trainable_mask
from detect_to_track_tpu_torch import trainer
from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
from detect_to_track_tpu_torch.losses import track_loss
from detect_to_track_tpu_torch.models import DetectTrackModule
from detect_to_track_tpu_torch.models.convert import from_jax_params
from detect_to_track_tpu_torch.utils import space_to_depth2

TINY = dict(
    N_CLASSES=6,
    BATCH_SIZE=2,
    INPUT_SHAPE=(64, 96),
    FM_STRIDE=16,
    ANCHOR_AREAS=(0.02, 0.08),
    ANCHOR_ASPECT_RATIOS=(0.5, 1.0, 2.0),
    MAX_LABELS=8,
    PRE_NMS_TOPK=64,
    MAX_ROIS=16,
    MAX_DETS=8,
    D_MAX=2,
    K=3,
    COMPUTE_DTYPE="float32",
    TRAIN_ROI_CONF_THRESH=0.1,
    LOADER_WORKERS=1,
)


def _close(got, ref, name, rel=1e-5, rtol=1e-4):
    """float32 parity: atol relative to the largest magnitude (the two
    frameworks sum in different orders), rtol 1e-4."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rel * float(np.abs(ref).max()) + 1e-7, err_msg=name)


@pytest.fixture(scope="module")
def setup():
    """(port cfg, jax cfg, jax model, jax params (numpy), batch)."""
    cfg, jcfg = Config(**TINY), JaxConfig(**TINY)
    jmodel = JaxDetectTrack.from_config(jcfg, corr_impl="xla")
    h, w = cfg.INPUT_SHAPE
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, h, w, 3), jnp.float32), jnp.full((2, cfg.MAX_ROIS, 4), 0.3)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    manager = SyntheticVIDManager(n_samples=4, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES)
    batch = next(iter(trainer.BatchLoader(manager, cfg.BATCH_SIZE, cfg, seed=0)))
    # uint8 frames: the device-side /255 path
    batch = batch._replace(images=np.clip(np.rint(batch.images * 255.0), 0, 255).astype(np.uint8))
    return cfg, jcfg, jmodel, params, batch


def _port(cfg, params):
    model = DetectTrackModule.from_config(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return model


@pytest.fixture(scope="module")
def jax_step(setup):
    """one JAX train step from the initial params: (losses, updated params)."""
    cfg, jcfg, jmodel, params, batch = setup
    tx = jtrainer.make_optimizer(jcfg, params)
    step = jtrainer.make_train_step(jmodel, jcfg, tx)
    state = jtrainer.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=tx.init(params), step=jnp.zeros((), jnp.int32)
    )
    state, dtl = step(state, batch)
    return jax.device_get(dtl), jax.tree_util.tree_map(np.asarray, state.params)


def test_batch_loader_matches_jax(setup):
    cfg, jcfg, _, _, _ = setup
    port = next(iter(trainer.BatchLoader(SyntheticVIDManager(4, cfg.INPUT_SHAPE, n_classes=6), 2, cfg, seed=3)))
    ref = next(iter(jtrainer.BatchLoader(JaxSynthetic(4, jcfg.INPUT_SHAPE, n_classes=6), 2, jcfg, seed=3)))
    np.testing.assert_array_equal(port.images, ref.images)
    for got, want in zip(port.labels, ref.labels):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # HOST_S2D packs each pair 2x2 space-to-depth on the host
    s2d = next(iter(trainer.BatchLoader(SyntheticVIDManager(4, cfg.INPUT_SHAPE, n_classes=6), 2,
                                        cfg.replace(HOST_S2D=True), seed=3)))
    np.testing.assert_array_equal(s2d.images, space_to_depth2(port.images))


def test_forward_losses_match_jax(setup, jax_step):
    """the five components at the initial weights, against the JAX step's
    (corr_impl "xla" there, the plain correlation here)."""
    cfg, _, _, params, batch = setup
    ref, _ = jax_step
    got = trainer.make_eval_step(_port(cfg, params), cfg, device="cpu")(batch)
    for key, value in got.asdict().items():
        _close(value, ref.asdict()[key], key)
        assert np.isfinite(float(value))
    assert float(got.count) == 1.0
    assert got.t.item() > 0  # the synthetic pairs have tracks


def test_sgd_step_params_match_jax(setup, jax_step):
    """one SGD step: every parameter of the port against the JAX step's
    updated params through from_jax_params. The frozen ones stay bitwise.
    A moved tensor agrees within 1e-2 of its largest update: its gradient
    is a sum of many mixed-sign products of activations far larger than
    the result (the c5 path's conv weights differ by up to 5e-3 of their
    largest gradient, the RPN's by 1e-6)."""
    cfg, _, _, params, batch = setup
    _, ref_params = jax_step
    model = _port(cfg, params)
    step = trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model), device="cpu")
    dtl = step(batch)
    assert step.steps == 1 and np.isfinite(dtl.to_scalar(cfg.COEFS).item())
    ref = from_jax_params(ref_params)
    init = from_jax_params(params)
    got = model.state_dict()
    moved = 0
    for key, want in ref.items():
        update = (want - init[key]).abs().max().item()
        if update == 0:
            assert torch.equal(got[key], init[key]), key
            continue
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=0, atol=1e-2 * update, err_msg=key)
        moved += 1
    assert moved > 0


def test_trainable_stages_match_jax_mask(setup):
    cfg, _, _, params, _ = setup
    model = _port(cfg, params)
    trainer.make_optimizer(cfg, model)
    mask = resnet_trainable_mask(params, cfg.FIRST_TRAINABLE_STAGE)
    mask = from_jax_params(jax.tree_util.tree_map(lambda p, m: np.full(p.shape, m, np.float32), params, mask))
    for name, param in model.named_parameters():
        assert param.requires_grad == bool(mask[name].flatten()[0]), name
    assert not model.backbone.conv1.weight.requires_grad
    assert not model.backbone.layer2[0].conv1.weight.requires_grad
    assert model.backbone.layer3[0].conv1.weight.requires_grad


def test_frozen_params_do_not_move_and_loss_decreases(setup):
    """four steps on one batch: the stem and layers 1-2 stay bitwise,
    layer3 and the heads move, and the total loss goes down."""
    cfg, _, _, params, batch = setup
    model = _port(cfg, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model), device="cpu")
    losses = [step(batch).to_scalar(cfg.COEFS).item() for _ in range(4)]
    after = model.state_dict()
    for key in ("backbone.conv1.weight", "backbone.layer1.0.conv1.weight", "backbone.layer2.3.conv3.weight"):
        assert torch.equal(before[key], after[key]), key
    for key in ("backbone.layer3.0.conv1.weight", "rpn.conv.weight", "c_tracker.reg_fc.weight"):
        assert not torch.equal(before[key], after[key]), key
    assert losses[-1] < losses[0], losses
    assert step.steps == 4


def test_grad_accum_matches_unsplit_step(setup):
    cfg, _, _, params, batch = setup
    out = {}
    for accum in (1, 2):
        cfg_a = cfg.replace(GRAD_ACCUM=accum)
        model = _port(cfg_a, params)
        dtl = trainer.make_train_step(model, cfg_a, trainer.make_optimizer(cfg_a, model), device="cpu")(batch)
        out[accum] = (model.state_dict(), dtl)
    (p1, d1), (p2, d2) = out[1], out[2]
    for key in d1.asdict():
        _close(d2.asdict()[key], d1.asdict()[key], key)
    assert float(d2.count) == 1.0
    for key in p1:
        _close(p2[key], p1[key], key)
    model = _port(cfg, params)
    step3 = trainer.make_train_step(model, cfg.replace(GRAD_ACCUM=3), trainer.make_optimizer(cfg, model), device="cpu")
    with pytest.raises(ValueError, match="GRAD_ACCUM"):
        step3(batch)


def test_nan_policy_skip_rolls_back(setup):
    """a NaN batch between two clean ones leaves the parameters, the
    momentum and the step counter at the state after the first."""
    cfg, _, _, params, batch = setup
    cfg = cfg.replace(NAN_POLICY="skip")
    model = _port(cfg, params)
    opt = trainer.make_optimizer(cfg, model)
    step = trainer.make_train_step(model, cfg, opt, device="cpu")
    step(batch)
    snap_p = {k: v.clone() for k, v in model.state_dict().items()}
    snap_m = [opt.state[p]["momentum_buffer"].clone() for p in opt.param_groups[0]["params"]]
    bad = batch._replace(images=np.full(batch.images.shape, np.nan, np.float32))
    dtl = step(bad)
    assert not np.isfinite(dtl.to_scalar().item())
    assert step.steps == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, snap_p[k]), k
    for p, m in zip(opt.param_groups[0]["params"], snap_m):
        assert torch.equal(opt.state[p]["momentum_buffer"], m)
    step(batch)
    assert step.steps == 2


def test_track_loss_gradients_match_jax(setup):
    """the track loss alone, differentiated with respect to the tracker's
    inputs (both frames' c4 and c5 maps, c3 and the RPN features): the
    correlation backward runs through the plain version here and through
    JAX's autodiff of its reference there."""
    cfg, _, jmodel, params, _ = setup
    rng = np.random.default_rng(5)
    b, fh, fw, nl = 2, 4, 6, 5

    def pyr():
        return {
            "c3": rng.standard_normal((b, fh, fw, 512), dtype=np.float32),
            "c4": rng.standard_normal((b, fh, fw, 1024), dtype=np.float32),
            "c5": rng.standard_normal((b, fh, fw, 2048), dtype=np.float32),
        }

    p0, p1 = pyr(), pyr()
    r0, r1 = (rng.standard_normal((b, fh, fw, 512), dtype=np.float32) for _ in range(2))
    ij = rng.random((b, nl, 2), dtype=np.float32) * 0.6 + 0.2
    rois = np.concatenate([ij, rng.random((b, nl, 2), dtype=np.float32) * 0.4 + 0.1], -1)
    t_star = rng.standard_normal((b, nl, 4), dtype=np.float32) * 0.5
    valid = np.array([[True, True, False, True, False], [False, True, True, True, True]])

    def jloss(x):
        t_hat = jmodel.apply({"params": params}, x[0], x[1], x[2], x[3], rois, method="c_tracker")
        return jax.vmap(jax_track_loss)(t_hat, t_star, valid).mean()

    jx = ({k: jnp.asarray(v) for k, v in p0.items()}, {k: jnp.asarray(v) for k, v in p1.items()}, r0, r1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jx)

    model = _port(cfg, params)
    tx = (
        {k: torch.from_numpy(v).requires_grad_() for k, v in p0.items()},
        {k: torch.from_numpy(v).requires_grad_() for k, v in p1.items()},
        torch.from_numpy(r0).requires_grad_(),
        torch.from_numpy(r1).requires_grad_(),
    )
    t_hat = model.c_tracker(*tx, torch.from_numpy(rois))
    loss = track_loss(t_hat, torch.from_numpy(t_star), torch.from_numpy(valid)).mean()
    loss.backward()
    _close(loss, ref_loss, "track loss")
    for f in (0, 1):
        for key in ("c3", "c4", "c5"):
            _close(tx[f][key].grad, ref_grads[f][key], f"d{key} frame {f}", rel=1e-4)
            assert tx[f][key].grad.abs().max() > 0
    _close(tx[2].grad, ref_grads[2], "d reg frame 0", rel=1e-4)
    _close(tx[3].grad, ref_grads[3], "d reg frame 1", rel=1e-4)


def test_train_step_entry_points(setup):
    cfg, _, _, params, batch = setup
    model = _port(cfg, params)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model))
    assert DetectTrackModule.from_config(cfg.replace(REMAT=True), device="cpu").backbone.remat
    assert model.backbone.first_trainable_stage == cfg.FIRST_TRAINABLE_STAGE
