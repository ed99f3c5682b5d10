"""device ms an item (a pair, a frame) under the program's `d2t::backbone`
range: the backbone (models/resnet.py)."""

from ..trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "d2t::backbone")
