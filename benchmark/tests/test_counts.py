"""the FLOP and roofline counts on small shapes, worked out by hand."""

from __future__ import annotations

import pytest
import torch

from benchmark.counts import bounds, flops
from benchmark.tests import tiny


def test_conv_and_out_size():
    assert flops.out_size(64, 7, 2, 3, 1) == 32
    assert flops.out_size(38, 3, 1, 2, 2) == 38  # dilated 3x3 keeps the size
    assert flops.out_size(75, 3, 2, 1, 1) == 38
    # 2 x 4 x 5 outputs x 8 channels x 3 inputs x 3 x 3 taps
    assert flops.conv_flops(4, 5, 3, 8, 3) == 2 * 4 * 5 * 8 * 3 * 9
    assert flops.conv_flops(4, 5, 32, 8, 3, groups=4) == 2 * 4 * 5 * 8 * 8 * 9


def test_frame_convs_tiny():
    c = tiny.config()["config"]  # 64 x 96 input
    convs = {x.name: x for x in flops.frame_convs(c)}
    assert convs["conv1"].flops == 2 * 32 * 48 * 64 * 3 * 49
    # layer1 at 16 x 24, layer2 at 8 x 12, layers 3-4 at 4 x 6 (layer4 dilated)
    assert convs["layer1.0.conv1"].flops == 2 * 16 * 24 * 64 * 64
    assert convs["layer2.0.conv2"].flops == 2 * 8 * 12 * 128 * 128 * 9
    assert convs["layer2.0.downsample"].flops == 2 * 8 * 12 * 512 * 256
    assert convs["layer4.2.conv2"].flops == 2 * 4 * 6 * 512 * 512 * 9
    assert convs["rcnn.channel_reduce"].flops == 2 * 4 * 6 * 512 * 2048 * 9
    assert convs["rcnn.cls_sm_conv"].flops == 2 * 4 * 6 * 31 * 49 * 512
    assert len([n for n in convs if n.startswith("layer")]) == 3 * (3 + 4 + 6 + 3) + 4


def test_pair_counts_tiny():
    c = tiny.config()["config"]
    frame = sum(x.flops for x in flops.frame_convs(c))
    n = (2 * 4 + 1) ** 2
    corr = 2 * (512 + 1024 + 2048) * n * 4 * 6
    fc = (3 * n + 1024) * 49
    assert flops.pair_forward(c) == 2 * frame + corr + 2 * 16 * fc * 4


def test_corr_bound():
    # 2 maps of 1 x 2 x 3 x 8 bf16 and 9 f32 planes of 2 x 3: 408 bytes;
    # 2 x 6 x 8 x 4 = 384 operations
    ms, by = bounds.corr_bound_ms(1, 2, 3, 8, 1, 2, False)
    assert by == "bytes" and ms == pytest.approx(408 / 3.35e12 * 1e3)
    ms, by = bounds.corr_bound_ms(1, 64, 64, 4096, 8, 4, True)
    assert by == "operations" and ms == pytest.approx(2.0 * 64 * 64 * 4096 * 256 / 67e12 * 1e3)


def test_nms_compares():
    # slot 0 and 1 overlap (IoU 0.6 > 0.5), slot 2 stands apart, slot 3 invalid
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.2], [0.5, 0.54, 0.2, 0.2], [0.1, 0.1, 0.1, 0.1],
                           [0.5, 0.5, 0.2, 0.2]]])
    valid = torch.tensor([[True, True, True, False]])
    keep = torch.tensor([[True, False, True, False]])
    # kept 0 compares with 1 and 2 (3 is invalid); 1 falls; kept 2 has none after it
    assert bounds.nms_compares(boxes, valid, keep, 0.5) == 2
    ms, by = bounds.nms_bound_ms(boxes, valid, keep, 0.5)
    assert by == "bytes" and ms == pytest.approx((16 * 4 + 4 + 4) / 3.35e12 * 1e3)


def test_psroi_bounds_one_roi():
    # one roi covering a 4 x 4 map, k 2: each bin 2 x 2 pixels
    bd = torch.tensor([[[[0, 2], [2, 4], [0, 2], [2, 4]]]], dtype=torch.int32)
    pixels, _, _ = bounds.bin_pixels(bd, 4, 4)
    assert pixels.tolist() == [[[[4.0, 4.0], [4.0, 4.0]]]]
    # forward, 3 targets: 16 pixels x 3 read, 12 outputs, 8 bound ints;
    # 16 x 3 adds + 12 divisions
    ms, by = bounds.psroi_fwd_bound_ms(bd, 3, 2, 4, 4)
    assert by == "bytes" and ms == pytest.approx(4 * (48 + 12 + 8) / 3.35e12 * 1e3)
