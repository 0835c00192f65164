"""The whole train step's share of the chip's peak: the U-Net's forward
and backward FLOPs per image times the images trained in the traced
window, at the peak of the precision the step runs in, over the window's
seconds."""
from h100_bench.lib import counts


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or not ctx.get('images') or trace.window_s <= 0:
        return None
    least = (ctx['images'] * ctx['train_flops_per_image']
             / counts.PEAK_FLOPS[ctx['unet_precision']])
    return 100.0 * least / trace.window_s
