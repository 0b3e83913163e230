"""Encoder-decoder transformer (seamless-m4t-medium backbone).  Counterpart
of ``repro.models.encdec``.

The speech frontend is a stub: the caller supplies precomputed frame
embeddings (b, t_enc, d).  Encoder: bidirectional attention; decoder: causal
self-attention + cross-attention to the encoder output.  Layers are stacked
on a leading L axis and driven by a Python loop over that axis, which sums
layer by layer as the JAX package's ``scan_layers`` does.  ``loss_fn`` is
differentiable, each block under ``cfg.remat`` (:func:`.lm.remat`, its MLP's
down projection outside, as in :mod:`.lm`).  As in :mod:`.lm`, the decode
state is written **in place** and handed back.

Every dense GEMM (self/cross-attention projections, memory K/V, MLP,
unembedding logits) routes through the active ``repro_torch.backend``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..backend import matmul as bmm
from ..configs.base import ModelConfig
from .layers import (KVCacheSpec, _merge_heads, _per_head, _repeat_kv,
                     _sdpa, _split_heads, attention,
                     attention_param_specs, cache_fill, chunked_softmax_xent,
                     decode_attention, embed, embed_param_specs, logits_last,
                     layer_write, mlp, mlp_hidden, mlp_param_specs, rmsnorm,
                     rmsnorm_spec)
from .lm import _layer, _residual, _unbound, new_state, remat
from .shardlib import ParamSpec, shard

Params = Dict[str, Any]


def cross_attention_param_specs(cfg: ModelConfig, layers: int) -> Params:
    return attention_param_specs(cfg, layers=layers)


def cross_attention(x: torch.Tensor, mem_k: torch.Tensor, mem_v: torch.Tensor,
                    p: Params, cfg: ModelConfig) -> torch.Tensor:
    """x: (b, s, d) queries; mem_k/mem_v: (b, t, h_kv, dh) projected
    memory."""
    s = x.shape[1]
    q = _split_heads(bmm(x, p["wq"]), cfg.n_heads, cfg.d_head)
    k = _repeat_kv(mem_k, cfg.n_heads)
    v = _repeat_kv(mem_v, cfg.n_heads)
    keep = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
    o = _per_head(lambda q_, k_, v_: _sdpa(q_, k_, v_, keep, cfg.d_head),
                  q, k, v)
    return bmm(_merge_heads(o), p["wo"])


def project_memory(mem: torch.Tensor, p: Params, cfg: ModelConfig):
    k = _split_heads(bmm(mem, p["wk"]), cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(bmm(mem, p["wv"]), cfg.n_kv_heads, cfg.d_head)
    return k, v


def param_specs(cfg: ModelConfig) -> Params:
    Le, Ld = cfg.n_enc_layers, cfg.n_layers

    def norm(L):
        return ParamSpec((L, cfg.d_model), torch.float32, ("layers", None),
                         init="ones")

    enc = {
        "norm_attn": norm(Le),
        "norm_mlp": norm(Le),
        "attn": attention_param_specs(cfg, layers=Le),
        "mlp": mlp_param_specs(cfg, layers=Le),
    }
    dec = {
        "norm_self": norm(Ld),
        "norm_cross": norm(Ld),
        "norm_mlp": norm(Ld),
        "self_attn": attention_param_specs(cfg, layers=Ld),
        "cross_attn": cross_attention_param_specs(cfg, layers=Ld),
        "mlp": mlp_param_specs(cfg, layers=Ld),
    }
    return {**embed_param_specs(cfg), "encoder": enc, "decoder": dec,
            "enc_norm": rmsnorm_spec(cfg.d_model),
            "final_norm": rmsnorm_spec(cfg.d_model)}


def _enc_head(x, lp, cfg):
    """An encoder block up to its MLP's down projection: (x after
    attention, the MLP's hidden)."""
    h = rmsnorm(x, lp["norm_attn"])
    x = _residual(x + attention(h, lp["attn"], cfg, causal=False))
    h = rmsnorm(x, lp["norm_mlp"])
    return x, mlp_hidden(h, lp["mlp"], cfg)


def encode(params: Params, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    x = shard(frames.to(torch.bfloat16), "batch", None, None)
    for lp in _unbound(params["encoder"], cfg.n_enc_layers):
        x, hid = remat(_enc_head, cfg)(x, lp, cfg)
        x = _residual(x + bmm(hid, lp["mlp"]["w2"]))
    return rmsnorm(x, params["enc_norm"])


def _dec_head(x, mem, lp, cfg):
    """A decoder block up to its MLP's down projection."""
    h = rmsnorm(x, lp["norm_self"])
    x = _residual(x + attention(h, lp["self_attn"], cfg, causal=True))
    h = rmsnorm(x, lp["norm_cross"])
    mk, mv = project_memory(mem, lp["cross_attn"], cfg)
    x = _residual(x + cross_attention(h, mk, mv, lp["cross_attn"], cfg))
    h = rmsnorm(x, lp["norm_mlp"])
    return x, mlp_hidden(h, lp["mlp"], cfg)


def _dec_block(x, mem, lp, cfg):
    x, hid = remat(_dec_head, cfg)(x, mem, lp, cfg)
    return _residual(x + bmm(hid, lp["mlp"]["w2"]))


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder's ``batch["tokens"]``
    against ``batch["labels"]``, attending to ``batch["frames"]`` (a 0-d
    float32 tensor, differentiable)."""
    mem = encode(params, batch["frames"], cfg)
    x = embed(batch["tokens"], params)
    for lp in _unbound(params["decoder"], cfg.n_layers):
        x = _dec_block(x, mem, lp, cfg)
    x = rmsnorm(x, params["final_norm"])
    return chunked_softmax_xent(x, params["embedding"], batch["labels"],
                                cfg.loss_chunk, unroll=cfg.unroll_layers)


# ---------------------------------------------------------------------------
# Serving: cross-attention memory K/V are computed once at prefill; decoder
# self-attention uses a standard KV cache.
# ---------------------------------------------------------------------------


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int,
                       t_enc: Optional[int] = None) -> Params:
    t_enc = max_len // cfg.enc_frames_ratio if t_enc is None else t_enc
    self_kv = KVCacheSpec(layers=cfg.n_layers, batch=batch, max_len=max_len,
                          n_kv=cfg.n_kv_heads, d_head=cfg.d_head).specs()
    mem_shape = (cfg.n_layers, batch, t_enc, cfg.n_kv_heads, cfg.d_head)
    mem_logical = ("layers", "batch", "seq_tp", None, None)
    return {
        "kv": self_kv,
        "mem_k": ParamSpec(mem_shape, torch.bfloat16, mem_logical,
                           init="zeros"),
        "mem_v": ParamSpec(mem_shape, torch.bfloat16, mem_logical,
                           init="zeros"),
        "index": ParamSpec((batch,), torch.int32, ("batch",), init="zeros"),
    }


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Encode ``batch["frames"]`` and run the decoder over the prompt;
    returns (last-position logits, decode state).  The state's memory is as
    long as the frames: an engine's slot takes
    ``max_len // enc_frames_ratio`` of them.  The prompt's self-attention
    K/V for the cache are the ones ``attention`` projected, so a decoder
    layer runs 2 GEMMs fewer than the JAX package's compiled prefill, which
    projects them again (ROADMAP.md C4)."""
    mem = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_len = s if max_len is None else max_len
    x = embed(tokens, params)
    pos = torch.arange(s, device=x.device)
    state = new_state(decode_state_specs(cfg, b, max(max_len, s),
                                         t_enc=mem.shape[1]), x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["decoder"], i)
        h = rmsnorm(x, lp["norm_self"])
        a, k, v = attention(h, lp["self_attn"], cfg, causal=True,
                            positions=pos, return_kv=True)
        x = _residual(x + a)
        h = rmsnorm(x, lp["norm_cross"])
        mk, mv = project_memory(mem, lp["cross_attn"], cfg)
        x = _residual(x + cross_attention(h, mk, mv, lp["cross_attn"],
                                          cfg))
        h = rmsnorm(x, lp["norm_mlp"])
        x = _residual(x + mlp(h, lp["mlp"], cfg))
        cache_fill(state["kv"]["k"], i, k)
        cache_fill(state["kv"]["v"], i, v)
        layer_write(state["mem_k"], i, mk)
        layer_write(state["mem_v"], i, mv)
    x = rmsnorm(x, params["final_norm"])
    logits = logits_last(x[:, -1:], params["embedding"])
    state["index"].fill_(s)
    return logits, state


def decode_step(params: Params, state: Params, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decode step: tokens (b, 1) -> (logits (b, V), state).  The
    self-attention cache is written in place; ``index`` is a new tensor."""
    x = embed(tokens, params)
    index = state["index"]
    for i in range(cfg.n_layers):
        lp = _layer(params["decoder"], i)
        h = rmsnorm(x, lp["norm_self"])
        a, _ = decode_attention(h, lp["self_attn"], cfg,
                                _layer(state["kv"], i), index)
        x = _residual(x + a)
        h = rmsnorm(x, lp["norm_cross"])
        x = _residual(x + cross_attention(h, state["mem_k"][i],
                                          state["mem_v"][i],
                                          lp["cross_attn"], cfg))
        h = rmsnorm(x, lp["norm_mlp"])
        x = _residual(x + mlp(h, lp["mlp"], cfg))
    x = rmsnorm(x, params["final_norm"])
    logits = logits_last(x, params["embedding"])
    return logits, {**state, "index": index + 1}
