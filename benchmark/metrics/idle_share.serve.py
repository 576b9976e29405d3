"""Device layer, serving: the share of the traced stretch in which nothing
ran on the card, in percent."""
from harness import readers


def read(ctx):
    return readers.idle_share(ctx)
