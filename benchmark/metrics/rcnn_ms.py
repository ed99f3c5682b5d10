"""device ms an item (a pair, a frame) under the program's `d2t::rcnn`
range: the R-FCN head with PSROIPool (models/rfcn.py)."""

from ..trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "d2t::rcnn")
