"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres vision stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; sliding-window 4096
attention (sub-quadratic -> long_500k cell runs; DESIGN.md Sec. 6).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=32000,
    sliding_window=4096, rope_theta=1_000_000.0,
    frontend="vision", frontend_tokens=2880,   # anyres: base 576 + 4 tiles
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=256, vocab_size=512, sliding_window=16, frontend_tokens=8,
        attn_chunk=32, loss_chunk=32)
