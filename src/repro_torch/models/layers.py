"""Shared model building blocks: norms, RoPE, GQA attention (prefill /
cached decode, causal + sliding-window), SwiGLU/GELU MLPs, MoE (dense
dispatch), embedding and unembedding, and the sequence-chunked cross-entropy,
each differentiable by autograd (a routed GEMM's backward is the backend's
straight-through one).  Counterpart of ``repro.models.layers``; the
expert-parallel all-to-all MoE waits for the mesh (ROADMAP A14).

Numerics policy: params bf16 (norm scales f32), matmuls bf16 with f32
softmax/normalization.  Every dense GEMM goes through
``repro_torch.backend.matmul``.  Attention is the plain score/softmax/value
code (the JAX package has no attention kernel, so neither has the port).

The port updates the KV cache **in place**: :func:`decode_attention` writes
the new K/V rows into the cache tensors it was given and returns those same
tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..backend import matmul as bmm
from ..backend.base import routes_ideal
from ..configs.base import ModelConfig
from .shardlib import ParamSpec, shard

Params = Dict[str, Any]

NEG_INF = -2.0 ** 30   # large-but-finite mask value (avoids NaN from inf-inf)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), torch.float32, (None,), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., seq, d/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_param_specs(cfg: ModelConfig,
                          layers: Optional[int] = None) -> Params:
    """Stacked (layers-first) projection weights for the attention block."""
    L = cfg.n_layers if layers is None else layers
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    bf = torch.bfloat16
    specs = {
        "wq": ParamSpec(lead + (d, qd), bf, lax + ("fsdp", "tp")),
        "wk": ParamSpec(lead + (d, kvd), bf, lax + ("fsdp", "tp")),
        "wv": ParamSpec(lead + (d, kvd), bf, lax + ("fsdp", "tp")),
        "wo": ParamSpec(lead + (qd, d), bf, lax + ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec(lead + (qd,), bf, lax + ("tp",), init="zeros")
        specs["bk"] = ParamSpec(lead + (kvd,), bf, lax + ("tp",), init="zeros")
        specs["bv"] = ParamSpec(lead + (kvd,), bf, lax + ("tp",), init="zeros")
    return specs


def _qkv(x: torch.Tensor, p: Params, cfg: ModelConfig,
         positions: torch.Tensor):
    b, s, _ = x.shape
    q = bmm(x, p["wq"])
    k = bmm(x, p["wk"])
    v = bmm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kv, d) -> (b, s, heads, d) by group repetition."""
    b, s, kv, d = k.shape
    if kv == n_heads:
        return k
    rep = n_heads // kv
    k = k[:, :, :, None, :].expand(b, s, kv, rep, d)
    return k.reshape(b, s, n_heads, d)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
          causal: bool) -> torch.Tensor:
    """(q, k) boolean keep-mask."""
    if causal:
        keep = k_pos[None, :] <= q_pos[:, None]
    else:
        keep = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    if window is not None:
        keep = keep & (k_pos[None, :] > (q_pos[:, None] - window))
    return keep


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          keep: torch.Tensor, d_head: int,
          scores_f32: bool = True) -> torch.Tensor:
    """q:(b,qs,h,d) k,v:(b,ks,h,d) keep:(qs,ks) -> (b,qs,h,d).  f32 softmax."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(d_head)
    scores = torch.where(keep[None, None], scores, NEG_INF)
    if not scores_f32:
        # bf16 score pipeline: subtract the running max first so bf16's 8-bit
        # mantissa only ever sees bounded negatives
        scores = (scores - scores.amax(-1, keepdim=True).detach()
                  ).to(torch.bfloat16)
        w = F.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
    w = F.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _sdpa_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  keep: torch.Tensor, d_head: int, n_kv: int,
                  scores_f32: bool = True) -> torch.Tensor:
    """GQA without materializing repeated K/V: q reshaped (b, qs, kv, g, d)
    einsummed against the raw (b, ks, kv, d) K/V."""
    b, qs, h, d = q.shape
    g = h // n_kv
    qg = q.reshape(b, qs, n_kv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    scores = scores / math.sqrt(d_head)
    scores = torch.where(keep[None, None, None], scores, NEG_INF)
    if not scores_f32:
        scores = (scores - scores.amax(-1, keepdim=True).detach()
                  ).to(torch.bfloat16)
    w = F.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return o.reshape(b, qs, h, d)


def attention(x: torch.Tensor, p: Params, cfg: ModelConfig,
              causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """Prefill attention, q-chunked to bound the (q, k) score tensor.

    Full sequence K/V stay resident; queries are processed in cfg.attn_chunk
    blocks in a loop, so peak score memory is (b, h, chunk, s) instead of
    (b, h, s, s).  ``return_kv`` also yields the pre-repeat K/V for prefill
    cache construction (avoids re-projecting).
    """
    b, s, _ = x.shape
    pos = (torch.arange(s, device=x.device) if positions is None
           else positions)
    q, k, v = _qkv(x, p, cfg, pos.expand(b, s))
    k_raw, v_raw = k, v
    q = shard(q, "batch", None, "tp", None)
    if not cfg.gqa_grouped:
        k = _repeat_kv(k, cfg.n_heads)
        v = _repeat_kv(v, cfg.n_heads)
    k = shard(k, "batch", None, "tp", None)
    v = shard(v, "batch", None, "tp", None)

    ch = min(cfg.attn_chunk, s)
    if s % ch:
        ch = s  # fall back to single chunk on awkward sizes
    k_pos = pos

    def one_chunk(ci: int) -> torch.Tensor:
        qc = q[:, ci * ch:(ci + 1) * ch]
        q_pos = k_pos[ci * ch:(ci + 1) * ch]
        keep = _mask(q_pos, k_pos, cfg.sliding_window, causal)
        if cfg.gqa_grouped:
            return _sdpa_grouped(qc, k, v, keep, cfg.d_head, cfg.n_kv_heads,
                                 cfg.attn_scores_f32)
        return _sdpa(qc, k, v, keep, cfg.d_head, cfg.attn_scores_f32)

    o = torch.cat([one_chunk(ci) for ci in range(s // ch)], dim=1)
    o = o.reshape(b, s, cfg.q_dim)
    out = bmm(o, p["wo"])
    if return_kv:
        return out, k_raw, v_raw
    return out


# -- cached decode -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Decode-time KV cache layout (layers, batch, seq, kv heads, d_head).

    ``dtype_name='int8'`` stores symmetric-quantized K/V with per-(token,
    head) f32 scales — half the cache footprint/stream bytes."""

    layers: int
    batch: int
    max_len: int
    n_kv: int
    d_head: int
    dtype_name: str = "bf16"
    seq_axis: str = "seq_tp"

    def specs(self) -> Dict[str, ParamSpec]:
        shape = (self.layers, self.batch, self.max_len, self.n_kv, self.d_head)
        logical = ("layers", "batch", self.seq_axis, None, None)
        if self.dtype_name == "int8":
            sshape = shape[:-1] + (1,)
            return {
                "k": ParamSpec(shape, torch.int8, logical, init="zeros"),
                "v": ParamSpec(shape, torch.int8, logical, init="zeros"),
                "k_scale": ParamSpec(sshape, torch.float32, logical,
                                     init="zeros"),
                "v_scale": ParamSpec(sshape, torch.float32, logical,
                                     init="zeros"),
            }
        return {
            "k": ParamSpec(shape, torch.bfloat16, logical, init="zeros"),
            "v": ParamSpec(shape, torch.bfloat16, logical, init="zeros"),
        }


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., dh) -> int8 payload + per-vector f32 scale."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _cache_write(cache: torch.Tensor, rows: torch.Tensor,
                 slot: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[rows, slot] = new`` in place, dropping rows whose slot lies
    past the cache's end (an idle serving slot keeps counting; the JAX
    package's scatter drops such writes, an indexed assignment would
    fault)."""
    size = cache.shape[1]
    safe = slot.clamp(max=size - 1)
    inside = (slot < size).reshape(-1, *([1] * (new.dim() - 1)))
    cache[rows, safe] = torch.where(inside, new, cache[rows, safe])


def decode_attention(x: torch.Tensor, p: Params, cfg: ModelConfig,
                     kv: Dict[str, torch.Tensor], index
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token attention against a cache.

    x: (b, 1, d); kv: {"k", "v"[, "k_scale", "v_scale"]} with k/v of shape
    (b, S, n_kv, dh); index: scalar position, or per-row (b,) positions —
    continuous batching runs every slot at its own offset, so each batch row
    writes its K/V at and masks against its own index.  The cache tensors
    are written **in place**; returns (out, the same kv dict's tensors).
    """
    b = x.shape[0]
    idx = torch.as_tensor(index, device=x.device).to(torch.int64).expand(b)
    pos = idx[:, None]
    q, k_new, v_new = _qkv(x, p, cfg, pos)
    int8 = "k_scale" in kv

    k_cache, v_cache = kv["k"], kv["v"]
    rows = torch.arange(b, device=x.device)
    ring = (cfg.sliding_window is not None
            and k_cache.shape[1] <= cfg.sliding_window)
    slot = idx % k_cache.shape[1] if ring else idx   # ring buffer for SWA
    if int8:
        kq, ks = _quant_kv(k_new)
        vq, vs = _quant_kv(v_new)
        _cache_write(k_cache, rows, slot, kq[:, 0])
        _cache_write(v_cache, rows, slot, vq[:, 0])
        _cache_write(kv["k_scale"], rows, slot, ks[:, 0])
        _cache_write(kv["v_scale"], rows, slot, vs[:, 0])
        k_full = (k_cache.to(torch.float32) * kv["k_scale"]
                  ).to(torch.bfloat16)
        v_full = (v_cache.to(torch.float32) * kv["v_scale"]
                  ).to(torch.bfloat16)
    else:
        _cache_write(k_cache, rows, slot, k_new[:, 0])
        _cache_write(v_cache, rows, slot, v_new[:, 0])
        k_full, v_full = k_cache, v_cache

    k = _repeat_kv(k_full, cfg.n_heads)
    v = _repeat_kv(v_full, cfg.n_heads)
    s = k.shape[1]
    k_pos = torch.arange(s, device=x.device)
    if ring:
        # ring: everything valid once the row has wrapped
        valid = (k_pos[None, :] <= slot[:, None]) | (idx[:, None] >= s)
    else:
        valid = k_pos[None, :] <= idx[:, None]
        if cfg.sliding_window is not None:
            valid = valid & (k_pos[None, :] > idx[:, None]
                             - cfg.sliding_window)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(cfg.d_head)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = F.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, 1, cfg.q_dim)
    return bmm(o, p["wo"]), kv


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_param_specs(cfg: ModelConfig, layers: Optional[int] = None,
                    d_ff: Optional[int] = None) -> Params:
    L = cfg.n_layers if layers is None else layers
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    d = cfg.d_model
    ff = cfg.d_ff if d_ff is None else d_ff
    bf = torch.bfloat16
    specs = {
        "w1": ParamSpec(lead + (d, ff), bf, lax + ("fsdp", "tp")),
        "w2": ParamSpec(lead + (ff, d), bf, lax + ("tp", "fsdp")),
    }
    if cfg.act == "swiglu":
        specs["wg"] = ParamSpec(lead + (d, ff), bf, lax + ("fsdp", "tp"))
    return specs


def mlp_hidden(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """The MLP up to its down projection: the (..., d_ff) activations that
    ``w2`` multiplies."""
    if cfg.act == "swiglu":
        h = F.silu(bmm(x, p["wg"]).to(torch.float32)).to(x.dtype)
        h = h * bmm(x, p["w1"])
    else:
        # tanh form: jax.nn.gelu's default
        h = F.gelu(bmm(x, p["w1"]).to(torch.float32),
                   approximate="tanh").to(x.dtype)
    return shard(h, "batch", None, "tp")


def mlp(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    return bmm(mlp_hidden(x, p, cfg), p["w2"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_param_specs(cfg: ModelConfig, layers: Optional[int] = None) -> Params:
    L = cfg.n_layers if layers is None else layers
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    bf = torch.bfloat16
    if cfg.moe_shard == "expert":
        # experts over the TP axis (llama4: 16 experts == 16-way model axis)
        in_ax = lax + ("expert", "fsdp", None)
        out_ax = lax + ("expert", None, "fsdp")
    else:
        # experts replicated across TP, FFN hidden sharded (grok: 8 experts)
        in_ax = lax + (None, "fsdp", "tp")
        out_ax = lax + (None, "tp", "fsdp")
    specs = {
        "router": ParamSpec(lead + (d, e), torch.float32,
                            lax + ("fsdp", None)),
        "w1": ParamSpec(lead + (e, d, ff), bf, in_ax),
        "w2": ParamSpec(lead + (e, ff, d), bf, out_ax),
    }
    if cfg.act == "swiglu":
        specs["wg"] = ParamSpec(lead + (e, d, ff), bf, in_ax)
    return specs


def _router(x: torch.Tensor, p: Params, cfg: ModelConfig):
    """Top-k routing.  Returns (weights (t, k), indices (t, k), probs
    (t, E)) over flat tokens.  Tied probabilities keep the lower expert
    first, as ``jax.lax.top_k`` does: a stable descending sort
    (``torch.topk`` promises no order among ties)."""
    logits = bmm(x.to(torch.float32), p["router"])           # (t, E)
    probs = F.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.top_k], idx[:, :cfg.top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, probs


def moe_dense(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """Dense dispatch: every expert computes every token, gated combine.

    Under the ideal backend one einsum contracts all experts; any other
    backend gets E separate GEMMs an up/gate/down product, as the JAX
    package's non-ideal branch.  The combine sums the experts in index order
    in f32 and rounds once to bf16, so a token's output does not depend on
    how many tokens share the batch."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    w, idx, _ = _router(xt, p, cfg)
    gates = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                        device=x.device)
    gates.scatter_(1, idx, w)                                 # (t, E)
    if routes_ideal():
        def up(key):
            return torch.einsum("td,edf->etf", xt, p[key])

        def down(h):
            return torch.einsum("etf,efd->etd", h, p["w2"])
    else:
        # per-expert GEMMs through the active backend (E dense matmuls)
        def up(key):
            return torch.stack([bmm(xt, p[key][e])
                                for e in range(cfg.n_experts)])

        def down(h):
            return torch.stack([bmm(h[e], p["w2"][e])
                                for e in range(cfg.n_experts)])
    if cfg.act == "swiglu":
        h = F.silu(up("wg").to(torch.float32)).to(xt.dtype)
        h = h * up("w1")
    else:
        h = F.gelu(up("w1").to(torch.float32),
                   approximate="tanh").to(xt.dtype)
    y = down(h)                                               # (E, t, d)
    # the gates round to y's dtype first, as the JAX package's einsum
    g = gates.to(y.dtype).to(torch.float32)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        out = out + y[e].to(torch.float32) * g[:, e:e + 1]
    return out.to(y.dtype).reshape(b, s, d)


def moe(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.moe_impl == "ep_a2a":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl='ep_a2a' (expert-parallel all-to-all "
            "over a device mesh) is not ported yet (ROADMAP.md queue A, A14)")
    return moe_dense(x, p, cfg)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_param_specs(cfg: ModelConfig) -> Params:
    return {"embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                   torch.bfloat16, ("tp", "fsdp"),
                                   init="embed")}


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    x = p["embedding"][tokens]
    return shard(x, "batch", None, None)


def chunked_softmax_xent(x: torch.Tensor, emb: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 256,
                         unroll: bool = False) -> torch.Tensor:
    """Sequence-chunked cross-entropy against the (tied) unembedding, as a
    0-d float32 tensor: the mean over (b, s) of ``logsumexp - gold``.

    Never materialises the full (b, s, V) logits: chunks of ``chunk``
    positions produce (b, chunk, V) logits, reduce to a scalar and are
    dropped.  Every logits GEMM goes through ``backend.matmul``; ``emb.T``
    is a view.  ``unroll`` is accepted for the JAX package's signature (a
    Python loop is what both of its settings compute)."""
    b, s, _ = x.shape
    ch = min(chunk, s)
    if s % ch:
        ch = s
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(s // ch):
        xc = x[:, ci * ch:(ci + 1) * ch]
        yc = labels[:, ci * ch:(ci + 1) * ch].to(torch.int64)
        logits = bmm(xc, emb.T).to(torch.float32)            # (b, ch, V)
        logits = shard(logits, "batch", None, "tp")
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        loss = loss + (lse - gold).sum()
    return loss / (b * s)


def logits_last(x_last: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(b, 1, d) -> (b, V) logits for decode.  ``emb.T`` is a view: the tied
    unembedding is multiplied in place, through its strides."""
    out = bmm(x_last[:, 0], emb.T).to(torch.float32)
    return shard(out, "batch", "tp")
