"""Engine layer, chat: the turns' time from the call to their first token,
summed over the turns sent in the window, over the turns (host spans)."""


def read(ctx):
    ts = [s.first - s.due for s in ctx.window.served
          if s.measured and s.first is not None and s.first < ctx.host_end]
    return 1e3 * sum(ts) / len(ts) if ts else None
