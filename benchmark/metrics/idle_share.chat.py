"""Device layer, chat: the share of the traced stretch in which no kernel,
copy or set ran on the card (1 - the union of their intervals over the
stretch), in percent."""
from harness import readers


def read(ctx):
    return readers.idle_share(ctx)
