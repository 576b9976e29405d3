"""Scheduler layer, serving above the knee: the 90th percentile of (last
token time - first token time) / (tokens - 1), over the requests due in the
window that ended before the traced stretch: the time a full batch takes
a token, admissions between its steps included."""
from harness import readers, stats


def read(ctx):
    v = stats.percentile(readers.tpot_s(ctx, before=ctx.host_end), 90)
    return None if v is None else 1e3 * v
