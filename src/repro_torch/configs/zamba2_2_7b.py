"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 + one shared
attention block (32H MHA kv=32, d_head=80, d_ff=10240) applied every 6
layers; ssm_state=64; vocab=32000.  [arXiv:2411.15242; hf]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_d_head=64, ssm_chunk=64, shared_attn_period=6,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=256, vocab_size=512, ssm_state=16, ssm_d_head=16, ssm_chunk=8,
        shared_attn_period=2, attn_chunk=32, loss_chunk=32)
