"""Fixture: a real violation silenced by the inline allow marker."""

import torch.nn.functional as F


def ideal_only(x, p):
    return F.linear(x, p["w"])  # lint: allow=RP001 fixture exemption
