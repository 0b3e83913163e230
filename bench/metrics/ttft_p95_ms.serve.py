"""The 95th percentile of submit to first token (the engine's stamps) over
every request whose first token falls in the window, in ms."""

from bench.harness import readers


def read(rec):
    return readers.window_value(rec, "serve", "ttft_p95_ms")
