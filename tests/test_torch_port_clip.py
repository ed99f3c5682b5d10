"""clip tracking: the port's detect_clip and ClipTracker against the JAX
package's on the same weights and uint8 frames (the small f32 configuration
of tests/test_torch_port_detect.py), and the port's linker fed the JAX
package's own clip detections."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu.clip import ClipTracker as JaxClipTracker
from detect_to_track_tpu.config import Config as JaxConfig
from detect_to_track_tpu.inference import Detector as JaxDetector
from detect_to_track_tpu.models import DetectTrackModule as JaxDetectTrack
from detect_to_track_tpu.models.convert import convert_reference_state_dict
from detect_to_track_tpu_torch.clip import ClipTracker
from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.inference import ClipDetections, Detector
from detect_to_track_tpu_torch.models import DetectTrackModule
from detect_to_track_tpu_torch.models.convert import load_reference_state_dict
from tests.test_full_graph_parity import ARCH, D_MAX, HW, K, N_ANCHORS, N_CLASSES, _full_reference_state_dict
from tests.test_torch_port_detect import CFG_KW, TOL, _assert_same_rows

N_FRAMES = 5

# head scales: the box heads as in tests/test_torch_port_detect.py; the
# R-FCN class head and the tracker's Linear at magnitudes that keep the
# softmax unsaturated (confidences 0.92-1.0, not all 1.0 to the last bit)
# and the predicted transforms near 0.1, so links differ by more than f32
# rounding and psi is 1 on some links. With saturated confidences the
# linkers' decisions hang on last-bit ties, which two frameworks' sums
# break differently.
HEAD_SCALES = {
    "rpn.reg_fc": 0.002,
    "rcnn.reg_head.sm_conv": 0.002,
    "rcnn.cls_head.sm_conv": 0.02,
    "c_tracker.reg_fc": 1e-9,
}


@pytest.fixture(scope="module")
def detectors():
    sd = _full_reference_state_dict()
    for name, scale in HEAD_SCALES.items():
        for k in (f"{name}.weight", f"{name}.bias"):
            sd[k] = sd[k] * scale
    jmodel = JaxDetectTrack(
        backbone_arch=ARCH, n_anchors=N_ANCHORS, n_classes=N_CLASSES, k=K, d_max=D_MAX, r_hw=K, dtype=jnp.float32
    )
    jdet = JaxDetector(jmodel, {"params": convert_reference_state_dict(sd, ARCH)}, JaxConfig(**CFG_KW))
    cfg = Config(**CFG_KW)
    port = DetectTrackModule.from_config(cfg, device="cpu")
    port.load_state_dict(load_reference_state_dict(sd))
    return jdet, Detector(port, cfg, device="cpu")


@pytest.fixture(scope="module")
def frames():
    return (np.random.RandomState(11).rand(N_FRAMES, *HW, 3) * 255).astype(np.uint8)


def _rows(confs, boxes, valid, tracks=None):
    v = valid
    return confs[v], boxes[v], None if tracks is None else tracks[v]


def test_detect_clip_matches_jax(detectors, frames):
    jdet, det = detectors
    got = det.detect_clip(frames)
    ref = jdet.detect_clip(frames)
    assert isinstance(got, ClipDetections)
    d = det.cfg.max_dets
    assert got.confs.shape == (N_FRAMES, d, det.cfg.N_CLASSES + 1) and got.tracks.shape == (N_FRAMES - 1, d, 4)
    g = [f.numpy() for f in got]
    r = [np.asarray(f) for f in ref]
    for t in range(N_FRAMES):
        tracks = (g[3][t], r[3][t]) if t < N_FRAMES - 1 else (None, None)
        _assert_same_rows(_rows(g[0][t], g[1][t], g[2][t], tracks[0]), _rows(r[0][t], r[1][t], r[2][t], tracks[1]),
                          f"frame{t}")


def test_detect_clip_matches_detect_pairs(detectors, frames):
    """each frame's detections and each pair's tracks equal the pair API's
    on the same frames (the clip runs every frame once)."""
    _, det = detectors
    clip = det.detect_clip(list(frames))
    pairs = det.detect_pairs(np.stack([frames[:-1], frames[1:]], axis=1))
    for t in range(N_FRAMES - 1):
        for fr in (0, 1):
            torch.testing.assert_close(clip.valid[t + fr], pairs.valid[t, fr], rtol=0, atol=0)
            torch.testing.assert_close(clip.confs[t + fr], pairs.confs[t, fr], rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(clip.boxes[t + fr], pairs.boxes[t, fr], rtol=1e-5, atol=1e-6)
        v = clip.valid[t]
        torch.testing.assert_close(clip.tracks[t][v], pairs.tracks[t][v], rtol=1e-5, atol=1e-5)


def _canon_tubelets(tubelets):
    """tubelets in a canonical order: by span, then by rounded boxes."""
    return sorted(tubelets, key=lambda tb: (tb[0], tuple(np.round(tb[1], 3).ravel())))


def _assert_same_tubelets(got, ref, exact=False):
    assert len(got) == len(ref) and len(ref) > 0
    if not exact:  # the detections match as row sets: so do the tubelets
        got, ref = _canon_tubelets(got), _canon_tubelets(ref)
    for (span_a, boxes_a), (span_b, boxes_b) in zip(got, ref):
        assert span_a == span_b
        if exact:
            np.testing.assert_array_equal(boxes_a, boxes_b)
        else:
            np.testing.assert_allclose(boxes_a, boxes_b, **TOL)


@pytest.mark.parametrize("device_linking", [True, False])
def test_clip_tracker_matches_jax(detectors, frames, device_linking):
    """frame_chunk 3 on 5 frames: two chunks sharing frame 2."""
    jdet, det = detectors
    kw = dict(link_iou_thresh=0.5, min_len=1, frame_chunk=3, device_linking=device_linking)
    tracker = ClipTracker(det, **kw)
    got = tracker(list(frames))
    ref = JaxClipTracker(jdet, **kw)(list(frames))
    _assert_same_tubelets(got, ref)
    assert tracker.last_upload_s > 0
    assert max(e for (_, e), _ in got) == N_FRAMES - 1


class _JaxDetections:
    """a detector for the port's ClipTracker that returns the JAX
    detector's ClipDetections as CPU tensors."""

    def __init__(self, jdet):
        self.jdet = jdet
        self.device = torch.device("cpu")

    def _to_array(self, im):
        return self.jdet._to_array(im)

    def _maybe_s2d(self, x):
        return self.jdet._maybe_s2d(x)

    def detect_clip(self, window):
        out = self.jdet.detect_clip(window.numpy())
        return ClipDetections(*(torch.from_numpy(np.array(f)) for f in out))


@pytest.mark.parametrize("device_linking", [True, False])
def test_port_linker_on_jax_detections_matches_jax(detectors, frames, device_linking):
    """the same detections in, the same tubelets out: order, spans and boxes
    exact, for both linker paths."""
    jdet, _ = detectors
    kw = dict(link_iou_thresh=0.5, min_len=1, frame_chunk=3, device_linking=device_linking)
    got = ClipTracker(_JaxDetections(jdet), **kw)(list(frames))
    ref = JaxClipTracker(jdet, **kw)(list(frames))
    _assert_same_tubelets(got, ref, exact=True)


def test_clip_tracker_options(detectors, frames):
    _, det = detectors
    assert ClipTracker(det, pair_batch=2).frame_chunk == 3
    assert ClipTracker(det, frame_chunk=1).frame_chunk == 2
    with pytest.raises(ValueError, match="2 frames"):
        ClipTracker(det)(list(frames[:1]))
    # float frames that are exact 1/255 multiples: the uint8 upload gives
    # the float path's tubelets; min_len drops the short ones
    flt = list(frames.astype(np.float32) / 255.0)
    a = ClipTracker(det, min_len=1, uint8_upload=True)(flt)
    b = ClipTracker(det, min_len=1, uint8_upload=False)(flt)
    _assert_same_tubelets(a, b)
    long_only = ClipTracker(det, min_len=3)(list(frames))
    assert [tb for tb in a if tb[0][1] - tb[0][0] + 1 >= 3] and all(e - s + 1 >= 3 for (s, e), _ in long_only)
