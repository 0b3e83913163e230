"""Config system: model, shape and run configurations for every assigned
architecture (DESIGN.md Sec. 3)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

VOCAB_PAD_MULTIPLE = 256   # vocab padded so TP-16 sharding always divides


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return (v + multiple - 1) // multiple * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    # attention options
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    attn_chunk: int = 1024           # q-chunk for memory-bounded attention
    # mlp
    act: str = "swiglu"              # swiglu | gelu
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "dense"          # dense | ep_a2a
    moe_shard: str = "ffn"           # which dim takes the TP axis:
    #   "expert": experts sharded over model axis (needs E % axis == 0)
    #   "ffn":    experts replicated, FFN hidden dim sharded (any E)
    capacity_factor: float = 1.25
    shared_expert: bool = False      # llama4-style always-on expert
    # ssm (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_d_head: int = 64
    ssm_chunk: int = 64
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    shared_attn_period: int = 0
    # enc-dec
    n_enc_layers: int = 0
    enc_frames_ratio: int = 4        # encoder frames = seq_len // ratio
    # frontend stubs (vlm: patch embeddings, audio: frame embeddings)
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    # training
    loss_chunk: int = 256            # sequence-chunked cross-entropy
    remat: str = "full"              # full | dots | none
    dtype: str = "bfloat16"
    # roofline instrumentation: python-unroll every repetition that lax.scan
    # would hide from cost_analysis (layer stack, CE chunks, attn chunks).
    # Compile-time O(L) — used only by the unroll-delta FLOP estimator.
    unroll_layers: bool = False
    # ---- performance knobs (EXPERIMENTS.md §Perf; defaults = paper-faithful
    # baseline, optimized variants flip them) -------------------------------
    gqa_grouped: bool = False        # grouped-GQA einsum (no K/V head repeat)
    attn_scores_f32: bool = True     # False: bf16 score pipeline (max-sub)
    remat_save_attn: bool = False    # checkpoint attention outputs (no bwd
    #                                  recompute of the score pipeline)
    kv_cache_dtype: str = "bf16"     # bf16 | int8 (quantized KV + f32 scales)
    serve_weight_layout: str = "fsdp_tp"  # fsdp_tp | tp2d (decode: weights
    #                                  stationary over data x model, psum acts)
    fused_rwkv_proj: bool = False    # single fused r/k/v/g/w projection
    ssm_bf16: bool = False           # bf16 recurrence internals (f32 decays)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (DESIGN.md Sec. 6 skip policy)"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The 40-cell applicability matrix (DESIGN.md Sec. 6)."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("skip: pure full-attention arch — 500k decode needs "
                       "sub-quadratic attention")
    return True, ""
