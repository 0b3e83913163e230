"""Fixture: exactly one RP001 violation (direct torch.matmul in models/)."""

import torch


def project(x, w):
    return torch.matmul(x, w)
