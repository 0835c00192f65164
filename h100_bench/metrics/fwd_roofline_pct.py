"""The forward pass's share of its roofline: the least time of one
forward pass (``lib/counts.py``, fp32 at the published peak) over the
device time a step of the kernels that a no-grad call of the cell's
operator launched in set-up (by the program's launch counters)."""
from h100_bench.lib import counts, tracing


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or not ctx.get('forward_keys') or not ctx.get('steps'):
        return None
    us = trace.kernel_time(tracing.kernels_of(ctx['forward_keys']))
    if us <= 0:
        return None
    least = counts.least_seconds(*ctx['solver']['forward'])
    return 100.0 * least / (us / 1e6 / ctx['steps'])
