"""``InversionEngine.warm_compile``'s own seconds in set-up: the kernel
library's build or load, the first launches and the capture of the step's
CUDA graph."""


def read(ctx):
    return ctx.get('warm_compile_s')
