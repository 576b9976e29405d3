"""Scheduler layer, serving: the decode rows the program's scheduler has
dispatched since it was built (its always-on counter, read through the
run's Context while the program is still in reach)."""


def read(ctx):
    sched = ctx.scheduler
    return None if sched is None else sched.rows_dispatched
