"""Device kernels in the traced slice over the model calls it made
(decode steps and prefills)."""

from bench.harness import readers


def read(rec):
    return readers.launches_per_call(rec, "serve")
