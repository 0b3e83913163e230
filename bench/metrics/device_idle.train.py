"""Share of the traced slice with no device record running, in % (the
train cells)."""

from bench.harness import readers


def read(rec):
    return readers.device_idle(rec, "train")
