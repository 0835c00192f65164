"""Device milliseconds a step of every traced kernel that is not the
solver's: the U-Net, RED, the losses, Adam, the metrics and the work
between jobs."""
from h100_bench.lib import tracing


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or not ctx.get('solver_keys') or not ctx.get('steps'):
        return None
    solver = tracing.kernels_of(ctx['solver_keys'])
    return trace.kernel_time(lambda n: not solver(n)) / 1e3 / ctx['steps']
