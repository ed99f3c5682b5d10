"""device ms an item (a pair, a frame) under the program's `d2t::proposal_filter`
range: the proposal filter: gate, top-k, NMS and cap (ops/nms.py)."""

from ..trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "d2t::proposal_filter")
