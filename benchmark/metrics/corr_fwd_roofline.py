"""% of its roofline: the correlation forward K1 (ops/csrc/corr_fwd.cu), 3 launches a call. The least time the card
could take (counts/bounds.py, on these calls' inputs) over the device time
of the op `d2t::corr_fwd`."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, "corr_fwd", "d2t::corr_fwd")
