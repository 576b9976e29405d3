"""Model-step layer, chat: the decode steps' least time on an H100 (their
real rows' operations at 989 TFLOP/s or bytes at 3.35 TB/s, whichever is
longer: the architecture's work count) over their device time (CUDA events around
each replay), in percent."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx, ["decode", "decode_k"])
