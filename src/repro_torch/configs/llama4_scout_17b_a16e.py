"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert (early fusion backbone).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, top_k=1, shared_expert=True, moe_impl="dense",
    moe_shard="expert",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=256, vocab_size=512, n_experts=4, top_k=1, shared_expert=True,
        attn_chunk=32, loss_chunk=32)
