"""seamless-m4t-medium [audio/encdec]: 12+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 — enc-dec; speech frontend stubbed to precomputed
frame embeddings.  [arXiv:2308.11596; hf]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_head=64, d_ff=4096, vocab_size=256206,
    frontend="audio", enc_frames_ratio=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_head=32, d_ff=256, vocab_size=512,
        attn_chunk=32, loss_chunk=32)
