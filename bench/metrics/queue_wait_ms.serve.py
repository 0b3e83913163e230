"""Mean of the engine's ``serve_queue_wait_seconds`` histogram (submit to
slot admission) over the window, in ms."""

from bench.harness import readers


def read(rec):
    return readers.counter_mean_ms(rec, "serve", "queue_wait_s", "queue_waits")
