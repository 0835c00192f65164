"""The whole inversion step's share of the chip's peak: the window's
useful operations, each class at the peak of the precision it runs in
(the solver's fp32 at the fp32 peak, the U-Net's at the peak of the
precision its convolutions ran in, read at set-up), over the traced
window's seconds."""
from h100_bench.lib import counts


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or not ctx.get('steps') or trace.window_s <= 0:
        return None
    solver = sum(ops for ops, _ in ctx['solver'].values())
    least = ctx['steps'] * (
        solver / counts.PEAK_FLOPS['fp32']
        + ctx['unet_flops_per_step'] / counts.PEAK_FLOPS[ctx['unet_precision']])
    return 100.0 * least / trace.window_s
