"""rwkv6-1.6b "Finch" [ssm]: 24L d_model=2048 (attention-free, 32 heads of
64) d_ff=7168 vocab=65536 — data-dependent decay WKV.  [arXiv:2404.05892;
unverified]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=7168, vocab_size=65536,
    ssm_chunk=64,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=256, vocab_size=512, ssm_chunk=8, attn_chunk=32, loss_chunk=32)
