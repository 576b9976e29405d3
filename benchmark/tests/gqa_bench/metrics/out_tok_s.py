"""Output tokens handed to the clients in the window, a second of it."""
from harness import readers


def read(ctx):
    return readers.out_tok_s(ctx)
