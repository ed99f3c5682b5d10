"""the whole step's share of the card's bf16 dense peak (989 TFLOP/s): the
model FLOPs of an item (counts/flops.py, from the configuration's shapes)
times the items done per second over the traced run's unprofiled stretch."""

from ..counts.bounds import BF16_TENSOR_FLOPS


def read(ctx):
    if ctx.seconds_unprofiled <= 0 or ctx.items_unprofiled == 0:
        return None
    rate = ctx.items_unprofiled / ctx.seconds_unprofiled
    return 100.0 * ctx.runner.flops_per_item(ctx.state) * rate / BF16_TENSOR_FLOPS
