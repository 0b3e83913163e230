"""Decoder-only transformer LM: the dense architectures (phi4-mini,
starcoder2, granite, qwen1.5).  Counterpart of ``repro.models.lm``; the MoE
and VLM branches and ``loss_fn`` are not ported yet.

Layers are stacked on a leading L axis (the JAX package's layout, so its
parameter trees convert leaf by leaf) and driven by a Python loop over that
axis.  The stacked KV cache ``(L, b, S, n_kv, d_head)`` is **updated in
place**, layer by layer: :func:`decode_step` returns the cache tensors it was
given.  Callers run under ``torch.inference_mode()``.

Every dense GEMM (qkv/o projections, MLP, unembedding logits) routes through
the active ``repro_torch.backend``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import (KVCacheSpec, _quant_kv, attention,
                     attention_param_specs, decode_attention, embed,
                     embed_param_specs, logits_last, mlp, mlp_param_specs,
                     rmsnorm, rmsnorm_spec)
from .shardlib import ParamSpec, tree_map

Params = Dict[str, Any]


def param_specs(cfg: ModelConfig) -> Params:
    if cfg.n_experts or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP.md queue A: MoE and VLM configs)")
    L = cfg.n_layers
    blocks: Params = {
        "norm_attn": ParamSpec((L, cfg.d_model), torch.float32,
                               ("layers", None), init="ones"),
        "norm_mlp": ParamSpec((L, cfg.d_model), torch.float32,
                              ("layers", None), init="ones"),
        "attn": attention_param_specs(cfg),
        "mlp": mlp_param_specs(cfg),
    }
    return {
        **embed_param_specs(cfg),
        "blocks": blocks,
        "final_norm": rmsnorm_spec(cfg.d_model),
    }


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def kv_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                  long_context: bool = False) -> KVCacheSpec:
    eff_len = max_len
    if cfg.sliding_window is not None:
        eff_len = min(max_len, cfg.sliding_window)   # ring buffer (SWA)
    return KVCacheSpec(layers=cfg.n_layers, batch=batch, max_len=eff_len,
                       n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
                       dtype_name="int8" if cfg.kv_cache_dtype == "int8"
                       else "bf16",
                       seq_axis="seq_full" if long_context else "seq_tp")


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int,
                       long_context: bool = False) -> Params:
    # per-row index: continuous batching runs each slot at its own position
    return {"kv": kv_cache_spec(cfg, batch, max_len, long_context).specs(),
            "index": ParamSpec((batch,), torch.int32, ("batch",),
                               init="zeros")}


def _decode_block(x, lp, kv_l, index, cfg):
    h = rmsnorm(x, lp["norm_attn"])
    a, kv_new = decode_attention(h, lp["attn"], cfg, kv_l, index)
    x = x + a
    h = rmsnorm(x, lp["norm_mlp"])
    return x + mlp(h, lp["mlp"], cfg), kv_new


def decode_step(params: Params, state: Params, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (b, 1) -> (logits (b, V), state).

    ``state["kv"]`` is written in place and handed back; ``index`` is a new
    tensor."""
    x = embed(tokens, params)
    index = state["index"]
    for i in range(cfg.n_layers):
        x, _ = _decode_block(x, _layer(params["blocks"], i),
                             _layer(state["kv"], i), index, cfg)
    x = rmsnorm(x, params["final_norm"])
    logits = logits_last(x, params["embedding"])
    return logits, {"kv": state["kv"], "index": index + 1}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Process a full prompt, building the KV cache; returns (last-position
    logits, decode state)."""
    x = embed(batch["tokens"], params)
    b, s, _ = x.shape
    max_len = s if max_len is None else max_len
    cache_len = kv_cache_spec(cfg, b, max_len).max_len
    pos = torch.arange(s, device=x.device)
    kv = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype,
                                         device=x.device),
                  kv_cache_spec(cfg, b, max_len).specs())
    keep = min(s, cache_len)            # SWA ring: keep the tail

    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        h = rmsnorm(x, lp["norm_attn"])
        a, k, v = attention(h, lp["attn"], cfg, causal=True, positions=pos,
                            return_kv=True)
        x = x + a
        h2 = rmsnorm(x, lp["norm_mlp"])
        x = x + mlp(h2, lp["mlp"], cfg)
        k, v = k[:, s - keep:], v[:, s - keep:]
        if cfg.kv_cache_dtype == "int8":
            kq, ks = _quant_kv(k)
            vq, vs = _quant_kv(v)
            kv["k"][i, :, :keep], kv["v"][i, :, :keep] = kq, vq
            kv["k_scale"][i, :, :keep] = ks
            kv["v_scale"][i, :, :keep] = vs
        else:
            kv["k"][i, :, :keep], kv["v"][i, :, :keep] = k, v

    x = rmsnorm(x, params["final_norm"])
    logits = logits_last(x[:, -1:], params["embedding"])
    state = {"kv": kv,
             "index": torch.full((b,), s, dtype=torch.int32,
                                 device=x.device)}
    return logits, state
