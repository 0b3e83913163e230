"""Decoder-only transformer LM covering the dense, MoE and VLM-backbone
architectures (llava-next-mistral, grok-1, llama4-scout, granite, qwen1.5,
starcoder2, phi4-mini).  Counterpart of ``repro.models.lm``.

Layers are stacked on a leading L axis (the JAX package's layout, so its
parameter trees convert leaf by leaf) and driven by a Python loop over that
axis.  ``loss_fn`` is differentiable: under autograd each block runs under
``cfg.remat`` (:func:`remat`, the reference's ``jax.checkpoint``).  The
stacked KV cache ``(L, b, S, n_kv, d_head)`` is **updated in place**, layer
by layer: :func:`decode_step` returns the cache tensors it was given; the
serving steps run under ``torch.inference_mode()``.

Every dense GEMM (qkv/o projections, MLP, MoE router and experts,
unembedding logits) routes through the active ``repro_torch.backend``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..backend import matmul as bmm
from ..backend import use_backend
from ..backend.base import routed_backend
from ..configs.base import ModelConfig
from .layers import (KVCacheSpec, _quant_kv, attention, cache_fill,
                     attention_param_specs, chunked_softmax_xent,
                     decode_attention, embed, embed_param_specs, logits_last,
                     mlp_hidden, mlp_param_specs, moe, moe_param_specs,
                     rmsnorm, rmsnorm_spec)
from .shardlib import ParamSpec, current_rules, shard, tree_map

Params = Dict[str, Any]


def param_specs(cfg: ModelConfig) -> Params:
    L = cfg.n_layers
    blocks: Params = {
        "norm_attn": ParamSpec((L, cfg.d_model), torch.float32,
                               ("layers", None), init="ones"),
        "norm_mlp": ParamSpec((L, cfg.d_model), torch.float32,
                              ("layers", None), init="ones"),
        "attn": attention_param_specs(cfg),
    }
    if cfg.n_experts:
        blocks["moe"] = moe_param_specs(cfg)
        if cfg.shared_expert:
            blocks["mlp"] = mlp_param_specs(cfg)
    else:
        blocks["mlp"] = mlp_param_specs(cfg)
    return {
        **embed_param_specs(cfg),
        "blocks": blocks,
        "final_norm": rmsnorm_spec(cfg.d_model),
    }


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda t: t[i], tree)


def _unbound(tree: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree as views, each stacked leaf
    unbound once.  Under autograd a select a layer would give back a
    full-size gradient of the stacked leaf for every layer (1.6 GB each for
    phi4-mini's ``w1``); unbind's backward stacks the layers' gradients
    once."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda u: u[i], parts) for i in range(n)]


def remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``cfg.remat`` where autograd records: "full" (the
    default) keeps only ``fn``'s inputs and runs it again in the backward
    pass (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``); "none" and "dots" keep what autograd saves, so no
    GEMM runs twice; ``remat_save_attn`` counts as "full" (ROADMAP C4: the
    reference's counts under those two differ).  The second run routes its
    GEMMs through the backend that the first one used, whatever is scoped
    when the backward pass runs."""
    if cfg.remat != "full" and not cfg.remat_save_attn:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        be = routed_backend()

        def body(*a):
            with (use_backend(be) if be is not None
                  else contextlib.nullcontext()):
                return fn(*a)
        return checkpoint(body, *args, use_reentrant=False)
    return run


def _ffn_head(h: torch.Tensor, lp: Params, cfg: ModelConfig
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """A block's feed-forward up to the MLP's down projection: (the
    experts' output or None, the (shared) MLP's hidden or None)."""
    y = moe(h, lp["moe"], cfg) if cfg.n_experts else None
    hid = (mlp_hidden(h, lp["mlp"], cfg)
           if not cfg.n_experts or cfg.shared_expert else None)
    return y, hid


def _ffn_sum(y: Optional[torch.Tensor], hid: Optional[torch.Tensor],
             lp: Params) -> torch.Tensor:
    """The rest of :func:`_ffn_head`: the MLP's down projection, added to
    the experts' output."""
    if hid is None:
        return y
    m = bmm(hid, lp["mlp"]["w2"])
    return m if y is None else y + m


def _ffn(h: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    """A block's feed-forward: the MLP, or the MoE plus the shared expert's
    MLP."""
    return _ffn_sum(*_ffn_head(h, lp, cfg), lp)


def _block_head(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                positions: Optional[torch.Tensor]):
    """A block up to its MLP's down projection: (x after attention,
    :func:`_ffn_head`'s pair)."""
    h = rmsnorm(x, lp["norm_attn"])
    x = _residual(x + attention(h, lp["attn"], cfg, causal=True,
                                positions=positions))
    h = rmsnorm(x, lp["norm_mlp"])
    return (x, *_ffn_head(h, lp, cfg))


def _residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout: split over the batch, whole over the
    sequence and the model width (the reference's block-end constraint;
    on a mesh it sums the row-parallel projections' partial products)."""
    return shard(x, "batch", None, None)


def _block(x: torch.Tensor, lp: Params, cfg: ModelConfig,
           positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer.  Only the head runs under :func:`remat`: the down
    projection of the MLP (dense, or the shared expert's) feeds the
    residual sum alone, so the reference's compiled backward drops its
    second run as dead code, and a train step runs as many GEMMs as the
    reference's."""
    x, y, hid = remat(_block_head, cfg)(x, lp, cfg, positions)
    return _residual(x + _ffn_sum(y, hid, lp))


def backbone(params: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding-space input -> final-norm output (a loop over the layer
    stack)."""
    for lp in _unbound(params["blocks"], cfg.n_layers):
        x = _block(x, lp, cfg, positions)
    return rmsnorm(x, params["final_norm"])


def _inputs_to_embedding(params: Params, batch: Dict[str, torch.Tensor],
                         cfg: ModelConfig) -> Tuple[torch.Tensor, int]:
    """Returns (x, n_prefix) where the first n_prefix positions carry no
    loss (VLM patch embeddings, put in front of the tokens)."""
    x = embed(batch["tokens"], params)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(torch.bfloat16)         # (b, p, d)
        return _residual(torch.cat([pe, x], dim=1)), pe.shape[1]
    return x, 0


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (a 0-d float32 tensor, differentiable); patch
    positions carry no loss."""
    x, n_prefix = _inputs_to_embedding(params, batch, cfg)
    y = backbone(params, x, cfg)[:, n_prefix:]
    return chunked_softmax_xent(y, params["embedding"], batch["labels"],
                                chunk=cfg.loss_chunk,
                                unroll=cfg.unroll_layers)


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
    x = _residual(x + a)
    h = rmsnorm(x, lp["norm_mlp"])
    return _residual(x + _ffn(h, lp, cfg)), kv_new


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


def new_state(specs: Params, device: torch.device) -> Params:
    """Zeros of a state's spec tree; under mesh rules each rank's shards
    alone (``torch.distributed.tensor.zeros``)."""
    rules = current_rules()
    if rules.mesh is None:
        return tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype,
                                               device=device), specs)
    from torch.distributed.tensor import zeros
    return tree_map(lambda sp: zeros(
        sp.shape, dtype=sp.dtype, device_mesh=rules.mesh,
        placements=rules.placements(sp.logical, sp.shape)), specs)


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Process a full prompt (behind its patch embeddings, if any), building
    the KV cache; returns (last-position logits, decode state)."""
    x, _ = _inputs_to_embedding(params, batch, cfg)
    b, s, _ = x.shape
    max_len = s if max_len is None else max_len
    cache_len = kv_cache_spec(cfg, b, max_len).max_len
    pos = torch.arange(s, device=x.device)
    kv = new_state(kv_cache_spec(cfg, b, max_len).specs(), x.device)
    keep = min(s, cache_len)            # SWA ring: keep the tail

    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        h = rmsnorm(x, lp["norm_attn"])
        a, k, v = attention(h, lp["attn"], cfg, causal=True, positions=pos,
                            return_kv=True)
        x = _residual(x + a)
        h2 = rmsnorm(x, lp["norm_mlp"])
        x = _residual(x + _ffn(h2, lp, cfg))
        k, v = k[:, s - keep:], v[:, s - keep:]
        if cfg.kv_cache_dtype == "int8":
            kq, ks = _quant_kv(k)
            vq, vs = _quant_kv(v)
            new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            new = {"k": k, "v": v}
        for key, val in new.items():
            cache_fill(kv[key], i, val)

    x = rmsnorm(x, params["final_norm"])
    logits = logits_last(x[:, -1:], params["embedding"])
    state = {"kv": kv,
             "index": torch.full((b,), s, dtype=torch.int32,
                                 device=x.device)}
    return logits, state
