"""% of its roofline: PSROIPool's forward (ops/csrc/psroi.cu), class and box head. The least time the card
could take (counts/bounds.py, on these calls' inputs) over the device time
of the op `d2t::psroi_fwd`."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, "psroi_fwd", "d2t::psroi_fwd")
