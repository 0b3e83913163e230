"""Fixture: exactly one RP004 violation (a torch draw from the process-wide
generator); the explicit-generator idioms below are allowed."""

import torch


def noisy(shape):
    return torch.randn(shape)


def seeded(shape, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen)
