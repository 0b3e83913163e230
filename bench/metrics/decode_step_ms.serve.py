"""Mean of the engine's ``decode_step`` spans in the window, in ms (the
span ends after the step's arg-max reaches the host, so it holds the
device's work)."""

from bench.harness import readers


def read(rec):
    return readers.span_mean_ms(rec, "serve", "decode_step")
