"""The model's FLOPs of the window's work over its seconds at the bf16
peak, in % (the serve cells)."""

from bench.harness import readers


def read(rec):
    return readers.mfu(rec, "serve")
