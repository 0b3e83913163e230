"""Fixture: exactly one RP005 violation (mutable default argument)."""


def collect(t, into={}):
    into[len(into)] = t
    return into


def fine(t, into=None):
    return {**(into or {}), 0: t}
