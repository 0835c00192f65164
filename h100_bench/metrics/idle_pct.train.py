"""The share of the traced window, between the harness's own window span,
in which no kernel, memcpy or memset runs on the device."""


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
