"""% of its roofline: the NMS op (ops/csrc/nms.cu: the IoU launch and the sweep). The least time the card
could take (counts/bounds.py, on these calls' inputs) over the device time
of the op `d2t::nms_mask`."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, "nms_mask", "d2t::nms_mask")
