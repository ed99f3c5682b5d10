"""the device's idle share of a call, in %: 1 - its busy time per item in
the profiled stretch (the union of its kernel, copy and set intervals in
the trace) over the wall time per item in the unprofiled stretch before
it. The profiled stretch's own wall time would count the profiler's host
work as idle."""


def read(ctx):
    p = ctx.profile
    if p.items == 0 or ctx.items_unprofiled == 0 or ctx.seconds_unprofiled <= 0:
        return None
    return 100.0 * (1.0 - (p.busy_s / p.items) / (ctx.seconds_unprofiled / ctx.items_unprofiled))
