"""Step-program layer, chat: the window's time between consecutive tokens
of a turn, over their count: one decode step each (host clock)."""


def read(ctx):
    w = ctx.window
    gaps = [b - a for s in w.served for a, b in zip(s.times, s.times[1:])
            if w.start <= a and b < ctx.host_end]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
