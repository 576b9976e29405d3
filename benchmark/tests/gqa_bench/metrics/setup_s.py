"""Process start to the window's start: imports, the kernels' build on a
checkout's first run or their load, weights drawn and quantized on the
card, the cell's step programs captured, one warm request."""


def read(ctx):
    return ctx.setup_s
