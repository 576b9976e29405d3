"""Engine layer, serving: the device time of an admission's prefill replay
(CUDA events around it), the mean over the window's admissions."""
from harness import readers


def read(ctx):
    return readers.device_ms_mean(ctx, ["prefill_slots"])
