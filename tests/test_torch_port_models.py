"""the PyTorch port's model heads held against the JAX package's modules on
the same weights (a reference-keyed state_dict through both converters) and
the same numpy inputs, in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu.models import DetectTrackModule as JaxDetectTrack
from detect_to_track_tpu.models import ResNetBackbone as JaxResNet
from detect_to_track_tpu.models.convert import convert_reference_state_dict
from detect_to_track_tpu_torch.config import Config, load_config
from detect_to_track_tpu_torch.models import DetectTrackModule, ResNetBackbone
from detect_to_track_tpu_torch.models.convert import (
    from_jax_params,
    load_reference_state_dict,
    random_reference_state_dict,
)
from detect_to_track_tpu_torch.models.resnet import ARCHS
from tests.test_full_graph_parity import ARCH, D_MAX, HW, K, N_ANCHORS, N_CLASSES, _full_reference_state_dict

T = torch.from_numpy
N_ROIS = 6


def _cfg(**kw):
    return Config(
        N_CLASSES=N_CLASSES, INPUT_SHAPE=HW, ANCHOR_AREAS=(0.05,), K=K, D_MAX=D_MAX, COMPUTE_DTYPE="float32", **kw
    )


def _close(got, ref, name, rel=1e-5):
    """float32 parity: atol relative to the output's largest magnitude (the
    two frameworks sum convolutions in different orders), rtol 1e-4."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=rel * float(np.abs(ref).max()) + 1e-7, err_msg=name)


@pytest.fixture(scope="module")
def models():
    """(jax module, jax variables, port module) on one reference-keyed
    state_dict."""
    sd = _full_reference_state_dict()
    jmodel = JaxDetectTrack(
        backbone_arch=ARCH, n_anchors=N_ANCHORS, n_classes=N_CLASSES, k=K, d_max=D_MAX, r_hw=K, dtype=jnp.float32
    )
    jvars = {"params": convert_reference_state_dict(sd, ARCH)}
    port = DetectTrackModule.from_config(_cfg(), device="cpu")
    port.load_state_dict(load_reference_state_dict(sd))
    return jmodel, jvars, port.eval()


def _rois(rng, b):
    ij = rng.rand(b, N_ROIS, 2) * 0.6 + 0.2
    hw = rng.rand(b, N_ROIS, 2) * 0.5 + 0.1
    return np.concatenate([ij, hw], -1).astype(np.float32)


def test_from_jax_params_maps_every_leaf():
    jmodel = JaxDetectTrack(
        backbone_arch=ARCH, n_anchors=N_ANCHORS, n_classes=N_CLASSES, k=K, d_max=D_MAX, r_hw=K, dtype=jnp.float32
    )
    h, w = HW
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, h, w, 3)), jnp.full((2, N_ROIS, 4), 0.4))
    )["params"]
    gen = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda s: gen.standard_normal(s.shape, dtype=np.float32), shapes)
    sd = from_jax_params(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))  # every leaf has a place
    port = DetectTrackModule.from_config(_cfg(), device="cpu")
    assert set(sd) == set(port.state_dict())  # and no port key is left over
    port.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        port.backbone.layer4[1].conv2.weight.detach().numpy(),
        np.transpose(params["backbone"]["layer4_1"]["conv2"]["kernel"], (3, 2, 0, 1)),
    )
    np.testing.assert_array_equal(
        port.c_tracker.reg_fc.weight.detach().numpy(), params["c_tracker"]["reg_fc"]["kernel"].T
    )
    with pytest.raises(KeyError, match="no counterpart"):
        from_jax_params({"rpn": {"conv": {"kernel_extra": np.zeros(3)}}})


def test_load_reference_state_dict_matches_convert():
    sd = _full_reference_state_dict()
    got = load_reference_state_dict(sd)
    ref = from_jax_params(convert_reference_state_dict(sd, ARCH))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    # tensors in, and torchvision's num_batches_tracked, are accepted
    sd_t = {k: T(v) for k, v in sd.items()}
    sd_t["backbone.1.bn1.num_batches_tracked"] = torch.tensor(5)
    assert set(load_reference_state_dict(sd_t)) == set(ref)


def test_random_reference_state_dict_has_reference_keys():
    cfg = _cfg()
    got = random_reference_state_dict(cfg, seed=3)
    ref = _full_reference_state_dict()
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32, k
    np.testing.assert_array_equal(got["rpn.conv.weight"], random_reference_state_dict(cfg, seed=3)["rpn.conv.weight"])


def test_backbone_matches_jax(models, rng):
    jmodel, jvars, port = models
    x = rng.rand(2, *HW, 3).astype(np.float32)
    ref = jmodel.apply(jvars, jnp.asarray(x), method="backbone")
    with torch.no_grad():
        got = port.backbone(T(x))
    for key, stride in (("c3", 8), ("c4", 16), ("c5", 16)):
        assert got[key].shape[1:3] == (HW[0] // stride, HW[1] // stride)
        _close(got[key], ref[key], key)


def test_resnext_backbone_matches_jax(rng):
    """grouped convs: JAX init params through from_jax_params."""
    arch = "resnext50_32x4d"
    x = rng.rand(1, 32, 48, 3).astype(np.float32)
    jb = JaxResNet(arch=arch)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jb.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    ref = jax.jit(jb.apply)({"params": params}, jnp.asarray(x))
    port = ResNetBackbone(arch)
    sd = {k[len("backbone."):]: v for k, v in from_jax_params({"backbone": params}).items()}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(T(x))
    for key in ("c3", "c4", "c5"):
        _close(got[key], ref[key], key)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_backbone_stride_contract(arch):
    """c3/c4/c5 at strides 8/16/16 with 512/1024/2048 channels (shapes only,
    on the meta device)."""
    with torch.device("meta"):
        out = ResNetBackbone(arch)(torch.zeros(1, 64, 128, 3))
    assert out["c3"].shape == (1, 8, 16, 512)
    assert out["c4"].shape == (1, 4, 8, 1024)
    assert out["c5"].shape == (1, 4, 8, 2048)


def test_rpn_matches_jax(models, rng):
    jmodel, jvars, port = models
    c4 = rng.randn(2, 4, 6, 1024).astype(np.float32)
    ref = jmodel.apply(jvars, jnp.asarray(c4), method="rpn")
    with torch.no_grad():
        got = port.rpn(T(c4))
    for name, g, r in zip(("o_hat", "b_hat", "fm_reg"), got, ref):
        _close(g, r, name)
    assert got[0].shape == (2, 4 * 6 * N_ANCHORS, 2)


def test_rfcn_matches_jax(models, rng):
    jmodel, jvars, port = models
    c5 = rng.randn(2, 4, 6, 2048).astype(np.float32)
    rois = _rois(rng, 2)
    ref = jmodel.apply(jvars, jnp.asarray(c5), jnp.asarray(rois), method="rcnn")
    with torch.no_grad():
        got = port.rcnn(T(c5), T(rois))
    _close(got[0], ref[0], "c_hat")
    _close(got[1], ref[1], "b_hat")
    assert got[0].shape == (2, N_ROIS, N_CLASSES + 1)


@pytest.mark.parametrize("paper", [False, True], ids=["quirk", "paper"])
def test_rfcn_bin_major_maps_are_the_reference_maps_gathered(paper, rng):
    """the R-FCN's 1x1 convolutions with their weight and bias rows gathered
    bin-major (BinMajorRows) write the reference-layout maps' channels
    gathered by the channel map: the maps PSROIPool's kernels read. The
    parameters and state_dict keys stay the reference's."""
    from detect_to_track_tpu_torch.models.rfcn import RFCN
    from detect_to_track_tpu_torch.ops.pooling import bin_major_channels

    k = 3
    head = RFCN(N_CLASSES, k=k, in_channels=16, reduce_channels=8, paper_channel_layout=paper)
    assert set(head.state_dict()) == {f"{m}.{p}" for m in ("channel_reduce", "cls_sm_conv", "reg_sm_conv")
                                      for p in ("weight", "bias")}
    t = T(rng.randn(2, 8, 5, 7).astype(np.float32)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        for conv, rows, n_t in ((head.cls_sm_conv, head.cls_rows, N_CLASSES + 1), (head.reg_sm_conv, head.reg_rows, 4)):
            ref = conv(t).permute(0, 2, 3, 1)[..., bin_major_channels(n_t, k, paper)]
            got = torch.nn.functional.conv2d(t, *rows(conv.weight, conv.bias)).permute(0, 2, 3, 1)
            assert got.is_contiguous()
            assert torch.equal(got, ref)


def _pyramids(rng, c3_full=True):
    s = 2 if c3_full else 1

    def pyr():
        return {
            "c3": rng.randn(2, 4 * s, 6 * s, 512).astype(np.float32),
            "c4": rng.randn(2, 4, 6, 1024).astype(np.float32),
            "c5": rng.randn(2, 4, 6, 2048).astype(np.float32),
        }

    return pyr(), pyr(), rng.randn(2, 4, 6, 512).astype(np.float32), rng.randn(2, 4, 6, 512).astype(np.float32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("c3_full", [True, False])
def test_tracker_matches_jax(models, fused, c3_full, rng):
    """fused and materialized heads, c3 at twice c4's resolution or already
    downsampled."""
    jmodel, jvars, port = models
    p0, p1, r0, r1 = _pyramids(rng, c3_full)
    rois = _rois(rng, 2)
    jm = jmodel.clone(tracker_fused_head=fused)
    jx = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    ref = jm.apply(jvars, jx(p0), jx(p1), jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(rois), method="c_tracker")
    port.c_tracker.fused_head = fused
    try:
        with torch.no_grad():
            tx = lambda d: {k: T(v) for k, v in d.items()}  # noqa: E731
            got = port.c_tracker(tx(p0), tx(p1), T(r0), T(r1), T(rois))
    finally:
        port.c_tracker.fused_head = True
    _close(got, ref, f"t_hat fused={fused}")
    assert got.shape == (2, N_ROIS, 4)


def test_tracker_bf16_matches_jax(models, rng):
    """bf16 compute (fused head): both round the maps, the volumes and the
    fc weight to bf16 and sum the products in f32, so only the summation
    order differs: atol 1e-4 of the largest magnitude."""
    jmodel, jvars, port = models
    p0, p1, r0, r1 = _pyramids(rng)
    rois = _rois(rng, 2)
    jm = jmodel.clone(dtype=jnp.bfloat16)
    jx = lambda d: {k: jnp.asarray(v, jnp.bfloat16) for k, v in d.items()}  # noqa: E731
    ref = jm.apply(jvars, jx(p0), jx(p1), jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(rois), method="c_tracker")
    port.c_tracker.dtype = torch.bfloat16
    try:
        with torch.no_grad():
            tx = lambda d: {k: T(v).to(torch.bfloat16) for k, v in d.items()}  # noqa: E731
            got = port.c_tracker(tx(p0), tx(p1), T(r0), T(r1), T(rois))
    finally:
        port.c_tracker.dtype = torch.float32
    assert got.dtype == torch.float32
    _close(got, ref, "t_hat bf16", rel=1e-4)


def test_from_config_full_width_and_devices():
    cfg = load_config("cfg/default.yaml")
    port = DetectTrackModule.from_config(cfg, device="cpu", seed=1)
    jmodel = JaxDetectTrack.from_config(load_jax_cfg("cfg/default.yaml"))
    h, w = cfg.INPUT_SHAPE
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, h, w, 3)), jnp.full((2, cfg.MAX_ROIS, 4), 0.4))
    )["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(t.numel() for t in port.state_dict().values()) == n_jax
    assert port.c_tracker.fc_channels == 92659
    assert port.dtype is torch.bfloat16
    again = DetectTrackModule.from_config(cfg, device="cpu", seed=1)
    torch.testing.assert_close(again.rpn.conv.weight, port.rpn.conv.weight, rtol=0, atol=0)
    # HOST_S2D takes the same weights (the backbone regroups the stem)
    s2d = DetectTrackModule.from_config(cfg.replace(HOST_S2D=True), device="cpu", seed=1)
    assert s2d.state_dict().keys() == port.state_dict().keys()
    torch.testing.assert_close(s2d.backbone.conv1.weight, port.backbone.conv1.weight, rtol=0, atol=0)
    del s2d
    with pytest.raises(NotImplementedError):
        port(torch.zeros(1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DetectTrackModule.from_config(cfg)


def load_jax_cfg(path):
    from detect_to_track_tpu.config import load_config as j_load_config

    return j_load_config(path)
