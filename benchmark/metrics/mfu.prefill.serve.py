"""Model-step layer, serving: the admissions' least time for their real
prompt tokens (the architecture's work count: bucket padding is not work) over their
replays' device time, in percent."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx, ["prefill_slots"])
