"""Shared model building blocks: norms, RoPE, GQA attention (prefill /
cached decode, causal + sliding-window), SwiGLU/GELU MLPs, MoE (dense
dispatch), embedding and unembedding, and the sequence-chunked cross-entropy,
each differentiable by autograd (a routed GEMM's backward is the backend's
straight-through one), and the expert-parallel all-to-all MoE on a device
mesh.  Counterpart of ``repro.models.layers``.

On a mesh (``shardlib.use_rules`` with mesh rules) the operands are
``DTensor`` s.  Elementwise ops, norms and reductions propagate their
placements; attention runs per (batch, head) block and the KV cache is
written shard by shard, each rank on its own local tensors.

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
from .shardlib import ParamSpec, is_dtensor, shard

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
    q = _split_heads(q, cfg.n_heads, cfg.d_head)
    k = _split_heads(k, cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(v, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _head_axis(x: torch.Tensor, dim: int, heads: int) -> Optional[str]:
    """"tp" where the active rules' split of ``dim`` holds whole heads,
    else None (the dimension stays whole)."""
    from .shardlib import current_rules
    rules = current_rules()
    if rules.mesh is None or not is_dtensor(x):
        return None
    spec = rules.placements(("tp",), (heads,))
    return "tp" if any(p.is_shard() for p in spec) else None


def _split_heads(x: torch.Tensor, heads: int, d_head: int) -> torch.Tensor:
    """(b, s, heads * d_head) -> (b, s, heads, d_head).  On a mesh the
    last dimension stays split only where its parts hold whole heads (XLA
    reshards such a reshape by itself; DTensor needs it laid out first),
    and the gradient comes back in the same layout."""
    b, s = x.shape[0], x.shape[1]
    tp = _head_axis(x, 2, heads)
    x = shard(x, "batch", None, tp)
    return shard(x.reshape(b, s, heads, d_head), "batch", None, tp, None)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, s, heads, d_head) -> (b, s, heads * d_head), as
    :func:`_split_heads` lays it out."""
    b, s, heads, d_head = x.shape
    tp = _head_axis(x, 2, heads)
    x = shard(x, "batch", None, tp, None)
    return shard(x.reshape(b, s, heads * d_head), "batch", None, tp)


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


def _replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as a ``DTensor`` on ``mesh`` (a plain tensor: replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _batch_head_split(t: torch.Tensor, heads_split) -> list:
    """Placements of a (b, s, heads, ...) ``DTensor``'s per-(row, head)
    blocks: each mesh axis keeps its split of the batch (dim 0) where the
    parts divide it, and of the heads (dim 2) where ``heads_split(parts)``
    allows; everything else is whole."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    pl, b_parts, h_parts = [], 1, 1
    for i, p in enumerate(t.placements):
        n = mesh.size(i)
        if p.is_shard(0) and t.shape[0] % (b_parts * n) == 0:
            pl.append(Shard(0))
            b_parts *= n
        elif p.is_shard(2) and heads_split(h_parts * n):
            pl.append(Shard(2))
            h_parts *= n
        else:
            pl.append(Replicate())
    return pl


def _per_head(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *extra: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, *extra)`` -> (b, s_q, h, d): attention math, on each
    rank's (batch, heads) block where the operands are ``DTensor`` s.

    q, k, v: (b, s, heads, d).  Each (batch row, head) attends on its own,
    so the ranks keep their batch and head splits and gather the sequence
    and ``d_head``; the local math is the unsharded one, the gradients of
    each block complete.  The batch split must divide; heads may split
    unevenly (DTensor's ``torch.chunk`` parts, as XLA pads) where k has q's
    head count, and must divide where k's kv heads serve groups of q's.
    ``extra``:
    plain tensors without a batch axis (whole on every rank) or
    ``DTensor`` s with a leading batch axis (split as q's rows)."""
    if not any(is_dtensor(t) for t in (q, k, v)):
        return fn(q, k, v, *extra)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    q, k, v = (_replicated(t, mesh) for t in (q, k, v))
    pl = _batch_head_split(q, lambda parts: k.shape[2] == q.shape[2] or (
        q.shape[2] % parts == 0 and k.shape[2] % parts == 0))
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    extra = [e.redistribute(mesh, rows) if is_dtensor(e) else e
             for e in extra]
    return local_map(fn, out_placements=pl,
                     in_placements=(pl, pl, pl, *(rows if is_dtensor(e)
                                                  else None
                                                  for e in extra)),
                     device_mesh=mesh)(q, k, v, *extra)


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
            # the kv heads a rank holds serve its query heads
            return _per_head(
                lambda q_, k_, v_: _sdpa_grouped(
                    q_, k_, v_, keep, cfg.d_head, k_.shape[2],
                    cfg.attn_scores_f32), qc, k, v)
        return _per_head(lambda q_, k_, v_: _sdpa(
            q_, k_, v_, keep, cfg.d_head, cfg.attn_scores_f32), qc, k, v)

    o = torch.cat([one_chunk(ci) for ci in range(s // ch)], dim=1)
    out = bmm(_merge_heads(o), p["wo"])
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


def _cache_write(cache: torch.Tensor, slot: torch.Tensor,
                 new: torch.Tensor) -> None:
    """``cache[r, slot[r]] = new[r]`` for every row r, in place, dropping
    rows whose slot lies past the cache's end (an idle serving slot keeps
    counting; the JAX package's scatter drops such writes, an indexed
    assignment would fault).  On a ``DTensor`` cache (b, S, ...) split over
    its batch and sequence axes each rank writes the rows and slots it
    holds, in place in its shard (an indexed assignment into a split axis
    has no sharding rule): a slot outside the shard is dropped there."""
    start = 0
    if is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        mesh = cache.device_mesh
        rows_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0
                   else Replicate() for p in cache.placements]
        slot = _replicated(slot, mesh).redistribute(mesh, rows_pl).to_local()
        new = _replicated(new, mesh).redistribute(mesh, rows_pl).to_local()
        start = _shard_start(cache, 1)
        cache = cache.to_local()
    size = cache.shape[1]
    if size == 0 or cache.shape[0] == 0:
        return
    at = slot.to(torch.int64)
    if start:
        at = at - start
    safe = at.clamp(0, size - 1)
    tail = (1,) * (new.dim() - 1)
    inside = (safe == at).reshape(-1, 1, *tail)
    idx = safe.reshape(-1, 1, *tail).expand(-1, 1, *new.shape[1:])
    cache.scatter_(1, idx, torch.where(inside, new.unsqueeze(1),
                                       cache.gather(1, idx)))


def _shard_start(t: torch.Tensor, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of the
    ``DTensor`` ``t``: DTensor splits a dimension into ceil(size / parts)
    runs, the mesh axes that split it nested major to minor."""
    mesh = t.device_mesh
    coord, idx, parts = mesh.get_coordinate(), 0, 1
    for i, p in enumerate(t.placements):
        if p.is_shard() and p.dim == dim:
            idx = idx * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
    return idx * -(-t.shape[dim] // parts)


def layer_write(cache: torch.Tensor, layer: int, new: torch.Tensor) -> None:
    """``cache[layer] = new`` in place; on a ``DTensor`` each rank writes
    its shard (the layers axis is never split)."""
    if is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        mesh = cache.device_mesh
        if any(isinstance(p, Shard) and p.dim == 0
               for p in cache.placements):
            raise ValueError("layer_write: the layers axis is split")
        pl = [Shard(p.dim - 1) if isinstance(p, Shard) else Replicate()
              for p in cache.placements]
        new = _replicated(new, mesh).redistribute(mesh, pl).to_local()
        cache = cache.to_local()
    cache[layer] = new


def cache_fill(cache: torch.Tensor, layer: int, new: torch.Tensor) -> None:
    """``cache[layer, :, :n] = new`` in place, n = ``new.shape[1]`` (a
    prefill's K/V, or its scales); on a ``DTensor`` cache (L, b, S, ...)
    split over its batch and sequence axes each rank fills the slots it
    holds."""
    n, first = new.shape[1], 0
    if is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        mesh = cache.device_mesh
        rows_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 1
                   else Replicate() for p in cache.placements]
        new = _replicated(new, mesh).redistribute(mesh, rows_pl).to_local()
        first = _shard_start(cache, 2)
        cache = cache.to_local()
    lo = min(max(first, 0), n)
    hi = min(first + cache.shape[2], n)
    if hi > lo:
        cache[layer, :, lo - first:hi - first] = new[:, lo:hi]


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
    idx = (index if is_dtensor(index) else torch.as_tensor(
        index, device=x.device)).to(torch.int64).expand(b)
    pos = idx[:, None]
    q, k_new, v_new = _qkv(x, p, cfg, pos)
    int8 = "k_scale" in kv

    k_cache, v_cache = kv["k"], kv["v"]
    ring = (cfg.sliding_window is not None
            and k_cache.shape[1] <= cfg.sliding_window)
    slot = idx % k_cache.shape[1] if ring else idx   # ring buffer for SWA
    if int8:
        kq, ks = _quant_kv(k_new)
        vq, vs = _quant_kv(v_new)
        _cache_write(k_cache, slot, kq[:, 0])
        _cache_write(v_cache, slot, vq[:, 0])
        _cache_write(kv["k_scale"], slot, ks[:, 0])
        _cache_write(kv["v_scale"], slot, vs[:, 0])
        k_full = (k_cache.to(torch.float32) * kv["k_scale"]
                  ).to(torch.bfloat16)
        v_full = (v_cache.to(torch.float32) * kv["v_scale"]
                  ).to(torch.bfloat16)
    else:
        _cache_write(k_cache, slot, k_new[:, 0])
        _cache_write(v_cache, slot, v_new[:, 0])
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
    if is_dtensor(q):
        # per row, as q's rows: split with them (a plain index, from a
        # prefill, makes a plain mask)
        valid = _replicated(valid, q.device_mesh)
    o = _per_head(lambda q_, k_, v_, valid_: _decode_sdpa(
        q_, k_, v_, valid_, cfg.d_head), q, k, v, valid)
    return bmm(_merge_heads(o), p["wo"]), kv


def _decode_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, d_head: int) -> torch.Tensor:
    """q:(b,1,h,d) k,v:(b,S,h,d) valid:(b,S) -> (b,1,h,d).  f32 softmax."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(d_head)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = F.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


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


def _gates(xt: torch.Tensor, router: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """(t, E) float32 combine weights: each token's top-k router weights
    at its experts, zeros elsewhere."""
    w, idx, _ = _router(xt, {"router": router}, cfg)
    gates = torch.zeros((xt.shape[0], cfg.n_experts), dtype=torch.float32,
                        device=xt.device)
    return gates.scatter_(1, idx, w)


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
    if is_dtensor(xt):
        # routing is row by row: each rank routes its own tokens
        gates = _rows_local(lambda rows, r: _gates(rows, r, cfg), xt,
                            p["router"], table=True)
    else:
        gates = _gates(xt, p["router"], cfg)                  # (t, E)
    if routes_ideal() and not is_dtensor(xt):
        def up(key):
            return torch.einsum("td,edf->etf", xt, p[key])  # lint: allow=RP001 ideal-only

        def down(h):
            return torch.einsum("etf,efd->etd", h, p["w2"])  # lint: allow=RP001 ideal-only
    else:
        # per-expert GEMMs through the active backend (E dense matmuls; on
        # a mesh also on ideal: DTensor has no rule for the einsum's
        # merged (token, expert) reshapes)
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


def moe_ep_a2a(x: torch.Tensor, p: Params, cfg: ModelConfig
               ) -> torch.Tensor:
    """Expert-parallel MoE with all-to-all dispatch.

    Requires n_experts == size of the 'expert' mesh axis.  Tokens are split
    over the batch and expert axes; each rank buckets its tokens into
    per-expert capacity buffers, exchanges them with an all-to-all over the
    expert axis (``all_to_all_single``, a functional collective, inside
    ``local_map``), runs its resident expert, and sends the results back.
    Capacity C = int(T_local * top_k / E * capacity_factor + 1); overflow
    tokens contribute zero (Switch-style dropping).  Without a mesh (or an
    expert axis) this is :func:`moe_dense`."""
    from .shardlib import current_rules
    rules = current_rules()
    mesh = rules.mesh
    axis = rules.table.get("expert")
    if mesh is None or axis is None:
        return moe_dense(x, p, cfg)            # no mesh: smoke-test fallback
    e_axis = axis if isinstance(axis, str) else axis[0]
    names = tuple(mesh.mesh_dim_names)
    e_dim = names.index(e_axis)
    esize = mesh.size(e_dim)
    if cfg.n_experts != esize:
        raise ValueError(
            f"ep_a2a needs n_experts == mesh['{e_axis}'] ({cfg.n_experts} vs "
            f"{esize}); use moe_impl='dense'")
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    d = x.shape[-1]
    n_e, top_k = cfg.n_experts, cfg.top_k
    batch_axes = rules.table["batch"]
    batch_axes = (() if batch_axes is None else (batch_axes,)
                  if isinstance(batch_axes, str) else tuple(batch_axes))

    def exchange(t: torch.Tensor) -> torch.Tensor:
        # (E * cap, d): block i goes to expert rank i, block j comes from j
        out = all_to_all_single_autograd(t, None, None, (mesh, e_dim))
        return out.wait() if hasattr(out, "wait") else out

    def local(xl, router, wg, w1, w2):
        # xl: (b_local, s_local, d); expert weights: (1, d, ff) local shard
        bl, sl = xl.shape[0], xl.shape[1]
        t = bl * sl
        xt = xl.reshape(t, d)
        wgt, idx, _ = _router(xt, {"router": router}, cfg)
        cap = int(t * top_k / n_e * cfg.capacity_factor + 1)
        # position of each (token, k) among its expert's claims
        onehot = F.one_hot(idx, n_e).to(torch.int32)          # (t, k, E)
        flat = onehot.reshape(t * top_k, n_e)
        pos = torch.cumsum(flat, dim=0) * flat - 1            # rank in expert
        expert_pos = (pos.reshape(t, top_k, n_e) * onehot).sum(-1)  # (t, k)
        keep = expert_pos < cap
        # scatter tokens into the (E, cap, d) send buffer
        e_idx = idx.reshape(-1)
        c_idx = torch.where(keep, expert_pos, cap - 1).reshape(-1)
        src = torch.repeat_interleave(xt, top_k, dim=0)
        src = torch.where(keep.reshape(-1, 1), src, torch.zeros_like(src))
        buf = torch.zeros((n_e, cap, d), dtype=xl.dtype, device=xl.device)
        buf = buf.index_put((e_idx, c_idx), src, accumulate=True)
        recv = exchange(buf.reshape(n_e * cap, d))
        # the resident expert's FFN (weights arrive as (1, d, ff) shards)
        if cfg.act == "swiglu":
            h = F.silu(bmm(recv, wg[0]).to(torch.float32)).to(recv.dtype)
            h = h * bmm(recv, w1[0])
        else:
            h = F.gelu(bmm(recv, w1[0]).to(torch.float32),
                       approximate="tanh").to(recv.dtype)
        y = bmm(h, w2[0])
        back = exchange(y).reshape(n_e, cap, d)
        # each (token, k)'s result, combined with its router weight
        out_tk = back[e_idx, c_idx].reshape(t, top_k, d)
        out_tk = torch.where(keep[..., None], out_tk,
                             torch.zeros_like(out_tk))
        out = (out_tk * wgt[..., None].to(out_tk.dtype)).sum(1)
        return out.reshape(bl, sl, d)

    # tokens are split over BOTH the batch (data) and sequence (expert)
    # axes before dispatch, so no two ranks dispatch the same tokens
    x_pl = [Shard(0) if n in batch_axes else Shard(1) if n == e_axis
            else Replicate() for n in names]
    w_pl = [Shard(0) if n == e_axis else Replicate() for n in names]
    rep = [Replicate()] * len(names)
    # gradients: the router's sums over every split of the tokens, the
    # experts' over the batch split
    split = [isinstance(q, Shard) for q in x_pl]
    r_grad = [Partial() if sp else Replicate() for sp in split]
    w_grad = [Shard(0) if n == e_axis else Partial() if sp else Replicate()
              for n, sp in zip(names, split)]
    wg = p.get("wg", p["w1"])
    # the output goes back to the residual stream's layout (tokens whole
    # over the sequence, as the next layer's projections expect)
    x_home = [Replicate() if q.is_partial() else q
              for q in _replicated(x, mesh).placements]
    args = [_replicated(t, mesh) for t in (x, p["router"], wg, p["w1"],
                                           p["w2"])]
    args = [a.redistribute(mesh, pl) for a, pl in
            zip(args, (x_pl, rep, w_pl, w_pl, w_pl))]
    fn = local_map(local, out_placements=x_pl,
                   in_placements=(x_pl, rep, w_pl, w_pl, w_pl),
                   in_grad_placements=(x_pl, r_grad, w_grad, w_grad, w_grad),
                   device_mesh=mesh)
    return fn(*args).redistribute(mesh, x_home)


def moe(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.moe_impl == "ep_a2a":
        return moe_ep_a2a(x, p, cfg)
    return moe_dense(x, p, cfg)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_param_specs(cfg: ModelConfig) -> Params:
    return {"embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                   torch.bfloat16, ("tp", "fsdp"),
                                   init="embed")}


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    emb = p["embedding"]
    if is_dtensor(emb) or is_dtensor(tokens):
        x = _rows_local(lambda t, e: e[t], tokens, emb, table=True)
    else:
        x = emb[tokens]
    return shard(x, "batch", None, None)


def _rows_local(fn, rows: torch.Tensor, other: torch.Tensor,
                table: bool = False) -> torch.Tensor:
    """``fn(rows, other)`` on each rank's rows: ``rows`` keeps its batch
    split (dim 0) and is whole elsewhere; ``other`` is split as ``rows``
    (``table=False``: a row-wise partner) or whole on every rank
    (``table=True``: an embedding table, whose gradient then sums over the
    batch split).  The local op is the unsharded one (an index or gather
    over a split dimension has no dependable DTensor rule, ROADMAP C12)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (rows if is_dtensor(rows) else other).device_mesh
    rows, other = _replicated(rows, mesh), _replicated(other, mesh)
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in rows.placements]
    other_pl = [Replicate()] * mesh.ndim if table else pl
    grad = ([Partial() if isinstance(p, Shard) else Replicate() for p in pl]
            if table else pl)
    return local_map(fn, out_placements=pl, in_placements=(pl, other_pl),
                     in_grad_placements=(pl, grad), device_mesh=mesh)(
        rows.redistribute(mesh, pl), other.redistribute(mesh, other_pl))


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
        # the gold logit, picked from whole rows (ROADMAP C12)
        gold = (_rows_local(_pick, yc, logits) if is_dtensor(logits)
                else _pick(yc, logits))
        loss = loss + shard(lse - gold, "batch", None).sum()
    return loss / (b * s)


def _pick(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Each position's logit of its label."""
    return torch.gather(logits, -1, labels[..., None])[..., 0]


def logits_last(x_last: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(b, 1, d) -> (b, V) logits for decode.  ``emb.T`` is a view: the tied
    unembedding is multiplied in place, through its strides."""
    out = bmm(x_last[:, 0], emb.T).to(torch.float32)
    return shard(out, "batch", "tp")
