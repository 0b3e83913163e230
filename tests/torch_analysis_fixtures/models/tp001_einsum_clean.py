"""Fixture: activation-activation einsums must NOT trip RP001 (no
subscripted parameter operand), while a param-leaf einsum does elsewhere."""

import torch


def attention_scores(q, k):
    return torch.einsum("bqhd,bkhd->bhqk", q, k)
