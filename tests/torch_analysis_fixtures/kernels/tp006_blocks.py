"""Fixture: exactly one RP006 violation (literal block default bypassing
the tuning tables and launch plans); the None-defaulted twin is the allowed
idiom."""


def bad_launch(a, b, block_m=128):
    return a, b, block_m


def good_launch(a, b, block_m=None):
    return a, b, block_m
