"""Model-step layer, serving: the decode forwards' least time for their
active rows (the architecture's work count) over their replays' device time, in
percent."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx, ["decode", "decode_k"])
