"""Scheduler layer, serving above the knee: the 90th percentile of each
request's queue wait, the program's ``Request.admitted_at`` (set where the
scheduler gives the request its slot) less its ``submitted_at``, over the
requests due in the window that were admitted before the traced stretch.
The part of ``ttft_p90_ms.serve`` that is the backlog. A program whose
requests carry no ``admitted_at`` has nothing to read."""
from harness import readers, stats


def read(ctx):
    waits = []
    for s in readers.measured(ctx):
        at = getattr(s.req, "admitted_at", None)
        if at is not None and at < ctx.host_end:
            waits.append(at - s.req.submitted_at)
    v = stats.percentile(waits, 90)
    return None if v is None else 1e3 * v
