"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch attention + 4x GELU MLP (20.0B with this MLP form), code.  [arXiv:2405.04324; hf]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab_size=49152,
    act="gelu",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, d_head=32,
        d_ff=256, vocab_size=512, attn_chunk=32, loss_chunk=32)
