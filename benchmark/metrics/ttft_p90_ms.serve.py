"""Scheduler layer, serving above the knee: the 90th percentile of the time
from a request's due time to its first token, over the requests due in the
window that ended before the traced stretch (the profiler's stop stalls
the loop after it). Above the knee it follows the backlog: a tail with no
bound, read beside `out_tok_s`."""
from harness import readers, stats


def read(ctx):
    v = stats.percentile(readers.ttft_s(ctx, before=ctx.host_end), 90)
    return None if v is None else 1e3 * v
