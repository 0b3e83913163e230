"""Fixture: exactly one RP002 violation (torch call inside an async
handler)."""

import torch


async def handle(payload):
    return torch.as_tensor(payload)
