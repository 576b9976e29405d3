"""Step-program layer, serving: the window's host time in decode dispatch
and drain over the decode forwards dispatched in it (a K-step block counts
K)."""
from harness import readers


def read(ctx):
    w = ctx.window
    end = ctx.host_end
    t = ctx.rec.total("dispatch", w.start, end) + ctx.rec.total("drain", w.start, end)
    n = sum(r.steps for r in readers.runs(ctx, ["decode", "decode_k"]))
    return 1e3 * t / n if n else None
