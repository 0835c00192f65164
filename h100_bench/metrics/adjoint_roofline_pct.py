"""The adjoint pass's share of its roofline: the least time of one
adjoint pass (``lib/counts.py``) over the device time a step of the
solver's other kernels (every launch counter of the program that the
forward call did not move: the adjoint's steps and its shot sums)."""
from h100_bench.lib import counts, tracing


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or not ctx.get('solver_keys') or not ctx.get('steps'):
        return None
    keys = [k for k in ctx['solver_keys'] if k not in ctx['forward_keys']]
    us = trace.kernel_time(tracing.kernels_of(keys))
    if us <= 0:
        return None
    least = counts.least_seconds(*ctx['solver']['adjoint'])
    return 100.0 * least / (us / 1e6 / ctx['steps'])
