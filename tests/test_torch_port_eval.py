"""the port's evaluation against the JAX package's: `detection_map` on the
cases of tests/test_evaluation.py and on seeded random detections,
`evaluate_detector` on the small training configuration with JAX-initialised
weights (through `from_jax_params`), and the `--torch-weights` loader
(`models/convert.py::convert_torch_state_dict`) against the JAX package's
on a seeded torchvision-keyed state_dict, through both backbones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu import evaluation as jeval
from detect_to_track_tpu.config import Config as JaxConfig
from detect_to_track_tpu.data.synthetic import SyntheticVIDManager as JaxSynthetic
from detect_to_track_tpu.inference import Detector as JaxDetector
from detect_to_track_tpu.models import DetectTrackModule as JaxDetectTrack
from detect_to_track_tpu.models import ResNetBackbone as JaxResNet
from detect_to_track_tpu.models.resnet import convert_torch_state_dict as jax_convert_torch
from detect_to_track_tpu_torch import evaluation as teval
from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
from detect_to_track_tpu_torch.inference import Detector
from detect_to_track_tpu_torch.models import DetectTrackModule, ResNetBackbone
from detect_to_track_tpu_torch.models.convert import (
    convert_torch_state_dict,
    from_jax_params,
    random_reference_state_dict,
)
from tests.test_full_graph_parity import ARCH, D_MAX, HW, K, N_CLASSES
from tests.test_torch_port_models import _close
from tests.test_torch_port_train import TINY


def _onehotish(c, n_classes, conf):
    v = np.full(n_classes + 1, (1 - conf) / n_classes, np.float32)
    v[c] = conf
    return v


def _evaluation_cases():
    """the detection / ground-truth lists of tests/test_evaluation.py."""
    b = np.array([[0.3, 0.3, 0.2, 0.2], [0.7, 0.7, 0.2, 0.2]], np.float32)
    b2 = np.array([[0.5, 0.5, 0.3, 0.3]], np.float32)
    fp = np.array([[0.3, 0.3, 0.2, 0.2], [0.8, 0.8, 0.1, 0.1]], np.float32)
    perfect = (
        [np.stack([_onehotish(1, 3, 0.9), _onehotish(2, 3, 0.8)]), np.stack([_onehotish(3, 3, 0.95)])],
        [b, b2], [np.array([1, 2]), np.array([3])], [b, b2], 3,
    )
    missed = ([np.stack([_onehotish(1, 2, 0.9)])], [b[:1]], [np.array([1, 1])], [b], 2)
    fp_below = ([np.stack([_onehotish(1, 1, 0.9), _onehotish(1, 1, 0.8)])], [fp], [np.array([1])], [b[:1]], 1)
    fp_above = ([np.stack([_onehotish(1, 1, 0.5), _onehotish(1, 1, 0.8)])], [fp], [np.array([1])], [b[:1]], 1)
    return [perfect, missed, fp_below, fp_above]


def _random_case(seed, n_images=6, n_classes=4):
    """seeded detections jittered around the ground truth, with false
    positives, empty images and images without ground truth."""
    rng = np.random.RandomState(seed)
    det_c, det_b, gt_c, gt_b = [], [], [], []
    for i in range(n_images):
        g = rng.randint(0, 4) if i % 3 else 0
        gb = np.c_[rng.rand(g, 2) * 0.6 + 0.2, rng.rand(g, 2) * 0.2 + 0.1].astype(np.float32)
        d = rng.randint(0, 6)
        src = gb[rng.randint(0, g, d)] if g else np.c_[rng.rand(d, 2), np.full((d, 2), 0.2)]
        det_b.append((src + 0.03 * rng.randn(d, 4)).astype(np.float32))
        logits = rng.randn(d, n_classes + 1)
        det_c.append((np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32))
        gt_c.append(rng.randint(1, n_classes + 1, g))
        gt_b.append(gb)
    return det_c, det_b, gt_c, gt_b, n_classes


@pytest.mark.parametrize("case", list(range(4)) + [f"random{s}" for s in range(4)], ids=str)
def test_detection_map_matches_jax(case):
    args = _evaluation_cases()[case] if isinstance(case, int) else _random_case(int(case[6:]))
    got, ref = teval.detection_map(*args), jeval.detection_map(*args)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    r, p = np.array([0.25, 0.5, 1.0]), np.array([1.0, 0.6, 0.5])
    assert teval.average_precision(r, p) == jeval.average_precision(r, p)


def test_detection_map_rejects_unequal_lists():
    with pytest.raises(ValueError, match="same images"):
        teval.detection_map([np.zeros((0, 2))], [np.zeros((0, 4))], [], [], 1)


def test_evaluate_detector_matches_jax():
    """the TINY configuration with JAX-initialised weights on 5 synthetic
    pairs at 2 pairs per call (the tail padded by repetition): mAP and every
    per-class AP equal to 1e-6."""
    cfg, jcfg = Config(**TINY), JaxConfig(**TINY)
    jmodel = JaxDetectTrack.from_config(jcfg, corr_impl="xla")
    h, w = cfg.INPUT_SHAPE
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, h, w, 3), jnp.float32), jnp.full((2, cfg.MAX_ROIS, 4), 0.3)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = DetectTrackModule.from_config(cfg, device="cpu")
    port.load_state_dict(from_jax_params(params))
    kw = dict(n_samples=5, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES, seed=1)
    got = teval.evaluate_detector(Detector(port, cfg, device="cpu"), SyntheticVIDManager(**kw), cfg.N_CLASSES,
                                  batch_pairs=2)
    ref = jeval.evaluate_detector(JaxDetector(jmodel, {"params": params}, jcfg), JaxSynthetic(**kw), cfg.N_CLASSES,
                                  batch_pairs=2)
    assert got.keys() == ref.keys() and len(ref) > 1
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])


def _torchvision_state_dict(seed):
    """seeded random weights under torchvision ResNet keys (the backbone of
    a reference-keyed state_dict, plus the classifier the loader ignores)."""
    cfg = Config(N_CLASSES=N_CLASSES, INPUT_SHAPE=HW, ANCHOR_AREAS=(0.05,), K=K, D_MAX=D_MAX)
    sd = {k[len("backbone.1."):]: v for k, v in random_reference_state_dict(cfg, seed).items() if k.startswith("backbone.1.")}
    rng = np.random.default_rng(seed)
    sd["fc.weight"] = rng.standard_normal((1000, 2048), dtype=np.float32) * 0.01
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def test_torch_weights_loader_matches_jax():
    """`--torch-weights`: torch tensors in, the port's backbone (BatchNorm
    folded into FrozenBatchNorm) against the JAX backbone with the JAX
    package's conversion, on the same frames, within the f32 tolerance of
    tests/test_torch_port_models.py (1e-5 of the largest magnitude)."""
    sd = _torchvision_state_dict(5)
    port = ResNetBackbone(ARCH)
    port.load_state_dict(convert_torch_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, ARCH), strict=True)
    params = jax_convert_torch(sd, ARCH)
    x = np.random.RandomState(2).rand(2, *HW, 3).astype(np.float32)
    ref = jax.jit(JaxResNet(arch=ARCH).apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for key in ("c3", "c4", "c5"):
        _close(got[key], ref[key], key)
    with pytest.raises(KeyError, match="layer1.0.bn2"):
        convert_torch_state_dict({k: v for k, v in sd.items() if not k.startswith("layer1.0.bn2")}, ARCH)
