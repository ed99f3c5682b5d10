"""the frozen plain reference against the port at a tiny size on the CPU,
float32 on both sides: the whole pair detector (the same proposals,
detections and tracks), and the judge's numbers at rounding level. The
test imports both; the reference imports neither the port nor JAX."""

from __future__ import annotations

import torch

from benchmark import frames, weights
from benchmark.runners import pairs as runner
from benchmark.reference import judge, model as ref, ops as ref_ops
from benchmark.tests import tiny


def _setup(arch="resnet50"):
    c = tiny.config("float32")
    c["config"]["BACKBONE_ARCH"] = arch
    w = weights.make(c, 5, "cpu")
    cfg = runner.port_config(c["config"])
    det = runner.build_detector(cfg, w, "cpu")
    s = ref.Sizes.from_config(c["config"])
    anchors = torch.from_numpy(ref_ops.build_anchors(s.fm_hw, s.anchor_areas, s.anchor_ratios))
    data = frames.pairs(5, 2, tuple(c["config"]["INPUT_SHAPE"]))
    return w, det, s, anchors, data


def test_reference_detector_matches_the_port():
    w, det, s, anchors, data = _setup()
    got = det.detect_pairs(data)
    with torch.no_grad():
        for p in range(data.shape[0]):
            want = ref.detect_pair(w, torch.from_numpy(data[p]), anchors, s, ref.EXACT)
            assert torch.equal(got.valid[p], want.valid)
            v = want.valid
            assert int(v.sum()) > 0
            torch.testing.assert_close(got.boxes[p][v], want.boxes[v], rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(got.confs[p][v], want.confs[v], rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(got.tracks[p][v[0]], want.tracks[v[0]], rtol=1e-4, atol=1e-5)


def test_judge_reads_rounding_on_the_port():
    w, det, s, anchors, data = _setup()
    got = det.detect_pairs(data)
    outs = [ref.PairOutputs(*(x[p] for x in got)) for p in range(data.shape[0])]
    numbers = judge.judge(w, [torch.from_numpy(x) for x in data], anchors, s, outs, 3.5e-4)
    assert max(numbers["box_gap"], numbers["logit_gap"], numbers["track_gap"]) < 1e-4, numbers


def test_stable_bins():
    # a 7-bin roi over a 14-pixel map: edges every 2 pixels from pixel 3
    rois = torch.tensor([[0.5, 0.5, 1.0, 1.0], [17 / 28, 17 / 28, 1.0, 1.0]])
    # first roi: edges on pixel boundaries (0, 2, ..., 14) -> never stable;
    # second: edges at 1.5, 3.5, ..., 13.5 and 15.5, past the border
    got = judge.stable_bins(rois, 1e-3, 7, (14, 14))
    assert got.tolist() == [False, True]
    assert judge.stable_bins(rois[1:], 0.04, 7, (14, 14)).tolist() == [False]  # 0.04 x 14 > 0.5 pixel


def test_weights_are_the_ports_state_dict_and_follow_the_seed():
    c = tiny.config("float32")
    w = weights.make(c, 5, "cpu")
    det = runner.build_detector(runner.port_config(c["config"]), w, "cpu")
    assert set(w) == set(det.model.state_dict())
    again = weights.make(c, 5, "cpu")
    other = weights.make(c, 6, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert not torch.equal(w["backbone.conv1.weight"], other["backbone.conv1.weight"])
    # lecun-normal: std 1/sqrt(fan_in); the box heads x0.002
    assert abs(float(w["rpn.conv.weight"].std()) * (1024 * 9) ** 0.5 - 1) < 0.02
    assert abs(float(w["rpn.reg_fc.weight"].std()) * 512 ** 0.5 / 0.002 - 1) < 0.05
