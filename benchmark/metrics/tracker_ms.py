"""device ms an item (a pair, a frame) under the program's `d2t::tracker`
range: the tracker (models/correlation_tracker.py)."""

from ..trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "d2t::tracker")
