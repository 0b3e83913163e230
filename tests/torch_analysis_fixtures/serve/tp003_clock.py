"""Fixture: exactly one RP003 violation (direct perf_counter read); the
default-argument *reference* below is the allowed idiom and must not trip."""

import time


def stamp(clock=time.perf_counter):
    return time.perf_counter()
