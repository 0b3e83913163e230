"""State-space / linear-recurrence architectures:

* Mamba2 (SSD, chunked-parallel form + recurrent decode) — the zamba2-2.7b
  building block [arXiv:2405.21060 / 2411.15242];
* RWKV6 "Finch" time-mix with data-dependent decay + channel-mix
  [arXiv:2404.05892];
* Zamba2 hybrid: stacked Mamba2 blocks with one *shared* attention+MLP block
  applied every ``shared_attn_period`` layers.

Counterpart of ``repro.models.ssm``.  The chunked forms run on the port's
kernels: ``wkv6_chunked`` is one call of ``kernels.wkv6`` and the SSD core of
``mamba2_forward`` one call of ``kernels.ssd_chunk`` (each launches its CUDA
kernel for CUDA tensors and computes its plain version for CPU ones).  The
one difference in the numbers: the reference's ``wkv6_chunked`` clamps the
decay to the chunk's end, the chunk decay and the carried state's factor at
+-30, the kernel (as the Pallas kernel it replaces) at +-60; the two differ
only where a factor lies below exp(-30).  Decode uses the O(1) recurrent
updates.

Layers are stacked on a leading axis (the JAX package's layout) and driven
by Python loops over layer views.  The decode states are **updated in
place**: ``rwkv6_decode_step`` and ``zamba2_decode_step`` write every leaf
(``wkv``, ``ssm``, ``conv``, ``prev_*``, the shared block's KV cache and
``index``) into the tensors they were given and return that tree.  Every
dense GEMM goes through ``repro_torch.backend.matmul``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..backend import matmul as bmm
from ..backend.base import routes_ideal
from ..configs.base import ModelConfig
from ..kernels.ssd_chunk import ssd_chunk
from ..kernels.wkv6 import wkv6
from .layers import (_batch_head_split, _replicated, attention,
                     attention_param_specs, chunked_softmax_xent,
                     decode_attention, embed, embed_param_specs, logits_last,
                     mlp, mlp_param_specs, rmsnorm, rmsnorm_spec)
from .lm import _layer, _residual
from .shardlib import ParamSpec, is_dtensor

Params = Dict[str, Any]

EXP_CLAMP = 30.0


def _chunk(chunk: int, s: int) -> int:
    """The model's chunk rule: ``min(chunk, s)``, or the whole sequence when
    that does not divide it."""
    ch = min(chunk, s)
    return s if s % ch else ch


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def mamba2_dims(cfg: ModelConfig) -> Dict[str, int]:
    d_inner = 2 * cfg.d_model
    n_heads = d_inner // cfg.ssm_d_head
    conv_dim = d_inner + 2 * cfg.ssm_state          # x, B, C share the conv
    in_dim = 2 * d_inner + 2 * cfg.ssm_state + n_heads
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim,
                in_dim=in_dim, d_state=cfg.ssm_state, p=cfg.ssm_d_head)


def mamba2_param_specs(cfg: ModelConfig, layers: int) -> Params:
    dims = mamba2_dims(cfg)
    L, d = layers, cfg.d_model
    bf, f32 = torch.bfloat16, torch.float32
    return {
        "norm": ParamSpec((L, d), f32, ("layers", None), init="ones"),
        "in_proj": ParamSpec((L, d, dims["in_dim"]), bf,
                             ("layers", "fsdp", "tp")),
        "conv_w": ParamSpec((L, 4, dims["conv_dim"]), bf,
                            ("layers", None, "tp")),
        "A_log": ParamSpec((L, dims["n_heads"]), f32, ("layers", None),
                           init="zeros"),
        "D": ParamSpec((L, dims["n_heads"]), f32, ("layers", None),
                       init="ones"),
        "dt_bias": ParamSpec((L, dims["n_heads"]), f32, ("layers", None),
                             init="zeros"),
        "gate_norm": ParamSpec((L, dims["d_inner"]), f32, ("layers", None),
                               init="ones"),
        "out_proj": ParamSpec((L, dims["d_inner"], d), bf,
                              ("layers", "tp", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, kernel 4. x: (b, s, c), w: (4, c)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    return F.silu(out.to(torch.float32)).to(x.dtype)


def _split_zxbcdt(zxbcdt: torch.Tensor, dims: Dict[str, int]):
    return torch.split(zxbcdt, [dims["d_inner"], dims["conv_dim"],
                                dims["n_heads"]], dim=-1)


def mamba2_forward(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                   ssm_state: Optional[torch.Tensor] = None,
                   conv_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """Chunked SSD forward. x: (b, s, d) -> (b, s, d) [+ final states].

    The SSD core (the chunk math of ``kernels.ssd_chunk``, with ``dt``
    already through softplus and the ``D * x`` skip) is one call of
    ``kernels.ssd_chunk`` at the model's chunk: ``min(ssm_chunk, s)``, or
    ``s`` when that does not divide it.
    """
    dims = mamba2_dims(cfg)
    b, s, _ = x.shape
    zxbcdt = bmm(x, lp["in_proj"])
    z, xbc, dt = _split_zxbcdt(zxbcdt, dims)
    xbc = _causal_conv(xbc, lp["conv_w"], conv_state)
    xs, B, C = torch.split(xbc, [dims["d_inner"], dims["d_state"],
                                 dims["d_state"]], dim=-1)
    h, p, n = dims["n_heads"], dims["p"], dims["d_state"]
    xh = xs.reshape(b, s, h, p).to(torch.float32)
    dt = F.softplus(dt.to(torch.float32) + lp["dt_bias"])         # (b, s, h)
    R0 = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
          if ssm_state is None else ssm_state.to(torch.float32))
    y, R_final = ssd_chunk(xh, dt, lp["A_log"], B, C, lp["D"], R0,
                           chunk=_chunk(cfg.ssm_chunk, s))
    y = y.reshape(b, s, dims["d_inner"])

    gated = y * F.silu(z.to(torch.float32))
    gated = rmsnorm(gated.to(torch.bfloat16), lp["gate_norm"])
    out = bmm(gated, lp["out_proj"])
    if return_state:
        # pre-activation conv input tail: a slice of the projection already
        # computed above (a second GEMM would count its MACs twice)
        prev = (conv_state.to(xbc.dtype) if conv_state is not None else
                torch.zeros((b, 3, dims["conv_dim"]), dtype=xbc.dtype,
                            device=x.device))
        conv_out = torch.cat(
            [prev, zxbcdt[:, :, dims["d_inner"]:dims["d_inner"]
                          + dims["conv_dim"]]], dim=1)[:, -3:]
        return out, R_final, conv_out
    return out


def mamba2_step(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """Single-token recurrence. x: (b, 1, d); ssm_state: (b, h, n, p);
    conv_state: (b, 3, conv_dim) raw pre-conv inputs.  Returns (out, new
    ssm state, new conv window), new tensors: the caller writes them back."""
    dims = mamba2_dims(cfg)
    b = x.shape[0]
    zxbcdt = bmm(x, lp["in_proj"])
    z, xbc_new, dt = _split_zxbcdt(zxbcdt, dims)
    window = torch.cat([conv_state.to(xbc_new.dtype), xbc_new], dim=1)
    conv_w = lp["conv_w"]
    xbc = sum(window[:, i] * conv_w[i][None] for i in range(4))
    xbc = F.silu(xbc.to(torch.float32)).to(x.dtype)              # (b, conv)
    xs, B, C = torch.split(xbc, [dims["d_inner"], dims["d_state"],
                                 dims["d_state"]], dim=-1)
    h, p = dims["n_heads"], dims["p"]
    xh = xs.reshape(b, h, p).to(torch.float32)
    dt1 = F.softplus(dt[:, 0].to(torch.float32) + lp["dt_bias"])  # (b, h)
    da = torch.exp(torch.clamp(dt1 * -torch.exp(lp["A_log"]), -EXP_CLAMP,
                               0.0))
    Bf, Cf = B.to(torch.float32), C.to(torch.float32)            # (b, n)
    new_state = (ssm_state * da[:, :, None, None]
                 + torch.einsum("bn,bh,bhp->bhnp", Bf, dt1, xh))
    y = (torch.einsum("bn,bhnp->bhp", Cf, new_state)
         + lp["D"][None, :, None] * xh)
    y = y.reshape(b, 1, dims["d_inner"])
    gated = y * F.silu(z.to(torch.float32))
    gated = rmsnorm(gated.to(torch.bfloat16), lp["gate_norm"])
    out = bmm(gated, lp["out_proj"])
    return out, new_state, window[:, -3:]


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================


def rwkv6_dims(cfg: ModelConfig) -> Dict[str, int]:
    return dict(h=cfg.n_heads, p=cfg.d_head, d=cfg.d_model,
                lora=max(32, cfg.d_model // 64))


def rwkv6_param_specs(cfg: ModelConfig) -> Params:
    dims = rwkv6_dims(cfg)
    L, d, lora = cfg.n_layers, cfg.d_model, dims["lora"]
    bf, f32 = torch.bfloat16, torch.float32
    return {
        "norm_att": ParamSpec((L, d), f32, ("layers", None), init="ones"),
        "norm_ffn": ParamSpec((L, d), f32, ("layers", None), init="ones"),
        # time-mix interpolation coefficients for r,k,v,w,g
        "tmix_mu": ParamSpec((L, 5, d), f32, ("layers", None, None),
                             init="zeros"),
        "wr": ParamSpec((L, d, d), bf, ("layers", "fsdp", "tp")),
        "wk": ParamSpec((L, d, d), bf, ("layers", "fsdp", "tp")),
        "wv": ParamSpec((L, d, d), bf, ("layers", "fsdp", "tp")),
        "wg": ParamSpec((L, d, d), bf, ("layers", "fsdp", "tp")),
        "wo": ParamSpec((L, d, d), bf, ("layers", "tp", "fsdp")),
        # data-dependent decay: w = exp(-exp(base + tanh(x A) B))
        "w_base": ParamSpec((L, d), f32, ("layers", None), init="zeros"),
        "w_lora_a": ParamSpec((L, d, lora), bf, ("layers", "fsdp", None)),
        "w_lora_b": ParamSpec((L, lora, d), bf, ("layers", None, "tp")),
        "u": ParamSpec((L, dims["h"], dims["p"]), f32,
                       ("layers", None, None), init="zeros"),
        "ln_x": ParamSpec((L, d), f32, ("layers", None), init="ones"),
        # channel mix
        "cmix_mu": ParamSpec((L, 2, d), f32, ("layers", None, None),
                             init="zeros"),
        "ck": ParamSpec((L, d, cfg.d_ff), bf, ("layers", "fsdp", "tp")),
        "cv": ParamSpec((L, cfg.d_ff, d), bf, ("layers", "tp", "fsdp")),
        "cr": ParamSpec((L, d, d), bf, ("layers", "fsdp", "tp")),
    }


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, s, d) -> previous-token tensor; `prev` seeds position 0 (decode)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def wkv6_chunked(r, k, v, w_log, u, state, chunk: int,
                 compute_dtype=torch.float32, *,
                 state_out: Optional[torch.Tensor] = None):
    """Chunked WKV recurrence: one call of ``kernels.wkv6`` at the model's
    chunk (``min(chunk, s)``, or ``s`` when that does not divide it).

      y_t = r_t . (S_{t-1} + (u (*) k_t) v_t^T) ; S_t = diag(w_t) S_{t-1} + k_t v_t^T

    r,k,v: (b, s, h, p), taken in ``compute_dtype`` (float32, or bfloat16:
    the reference's ``cfg.ssm_bf16=True`` recurrence, the kernel's bf16
    route); w_log: (b, s, h, p) = log decay (<= 0), f32; u: (h, p); state:
    (b, h, p, p) f32.  Returns (y f32, final_state f32); ``state_out`` (may
    be ``state``) receives the final state.
    """
    r, k, v = (t.to(compute_dtype) for t in (r, k, v))
    ch = _chunk(chunk, r.shape[1])
    if any(is_dtensor(t) for t in (r, k, v, w_log, u, state)):
        return _wkv6_blocks(r, k, v, w_log, u, state, ch, state_out)
    return wkv6(r, k, v, w_log, u, state, chunk=ch, state_out=state_out)


def _wkv6_blocks(r, k, v, w_log, u, state, ch, state_out):
    """:func:`wkv6_chunked` on ``DTensor`` operands: each rank runs the
    recurrence on its (batch, head) block (``local_map``); the sequence and
    the head width stay whole.  The batch and head splits must divide."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in (r, k, v, w_log, u, state)
                if is_dtensor(t)).device_mesh
    r, k, v, w_log, u, state = (_replicated(t, mesh)
                                for t in (r, k, v, w_log, u, state))
    pl = _batch_head_split(r, lambda parts: r.shape[2] % parts == 0)
    u_pl = [Shard(0) if p == Shard(2) else Replicate() for p in pl]
    s_pl = [Shard(1) if p == Shard(2) else p for p in pl]
    fn = local_map(lambda *a: wkv6(*a, chunk=ch), out_placements=(pl, s_pl),
                   in_placements=(pl, pl, pl, pl, u_pl, s_pl),
                   device_mesh=mesh)
    y, final = fn(*(t.redistribute(mesh, q) for t, q in zip(
        (r, k, v, w_log, u, state), (pl, pl, pl, pl, u_pl, s_pl))))
    if state_out is None:
        return y, final
    state_out = _replicated(state_out, mesh)
    state_out.to_local().copy_(
        final.redistribute(mesh, state_out.placements).to_local())
    return y, state_out


def rwkv6_timemix(x, lp, cfg, state=None, prev=None, return_state=False, *,
                  state_out: Optional[torch.Tensor] = None):
    dims = rwkv6_dims(cfg)
    b, s, d = x.shape
    hp = (b, s, dims["h"], dims["p"])
    xs = _token_shift(x, prev)
    f32 = torch.float32
    # cfg.ssm_bf16: r, k, v and g in bf16, the recurrence on bf16 operands
    act = torch.bfloat16 if cfg.ssm_bf16 else f32
    if cfg.fused_rwkv_proj:
        # y_i = x @ W_i + (mu_i*delta) @ W_i: read x and delta ONCE through a
        # stacked projection instead of 5 separate mixed-input matmuls
        delta = xs - x
        W = torch.stack([lp["wr"], lp["wk"], lp["wv"], lp["wg"]])  # (4, d, d)
        mu = lp["tmix_mu"][:4].to(f32)                              # (4, d)
        W_mix = (mu[:, :, None] * W.to(f32)).to(W.dtype)
        if routes_ideal():
            base = torch.einsum("bsd,idf->ibsf", x, W)
            mixp = torch.einsum("bsd,idf->ibsf", delta, W_mix)
        else:
            base = torch.stack([bmm(x, W[i]) for i in range(4)])
            mixp = torch.stack([bmm(delta, W_mix[i]) for i in range(4)])
        rkvg = base + mixp
        r, k, v, gg = (rkvg[i].to(act) for i in range(4))
        r, k, v = r.reshape(hp), k.reshape(hp), v.reshape(hp)
        g = F.silu(gg.to(f32)).to(act)
        xw = x + lp["tmix_mu"][4][None, None].to(x.dtype) * delta
    else:
        def mix(i):
            return x + lp["tmix_mu"][i][None, None].to(x.dtype) * (xs - x)
        xr, xk, xv, xw, xg = (mix(i) for i in range(5))
        r = bmm(xr, lp["wr"]).to(act).reshape(hp)
        k = bmm(xk, lp["wk"]).to(act).reshape(hp)
        v = bmm(xv, lp["wv"]).to(act).reshape(hp)
        g = F.silu(bmm(xg, lp["wg"]).to(f32)).to(act)
    w_log = -torch.exp(lp["w_base"][None, None]
                       + bmm(torch.tanh(bmm(xw, lp["w_lora_a"]).to(f32)),
                             lp["w_lora_b"].to(f32)))
    w_log = w_log.reshape(hp)
    S0 = (torch.zeros((b, dims["h"], dims["p"], dims["p"]), dtype=f32,
                      device=x.device) if state is None else state)
    y, S = wkv6_chunked(r, k, v, w_log, lp["u"], S0, cfg.ssm_chunk or 64,
                        compute_dtype=act, state_out=state_out)
    y = y.reshape(b, s, d)
    y = rmsnorm(y.to(torch.bfloat16), lp["ln_x"]).to(f32)
    out = bmm((y * g.to(f32)).to(torch.bfloat16), lp["wo"])
    if return_state:
        return out, S, x[:, -1]
    return out


def rwkv6_channelmix(x, lp, prev=None, return_state=False):
    xs = _token_shift(x, prev)
    xk = x + lp["cmix_mu"][0][None, None].to(x.dtype) * (xs - x)
    xr = x + lp["cmix_mu"][1][None, None].to(x.dtype) * (xs - x)
    k = torch.square(F.relu(bmm(xk, lp["ck"]).to(torch.float32)))
    kv = bmm(k.to(torch.bfloat16), lp["cv"])
    out = torch.sigmoid(bmm(xr, lp["cr"]).to(torch.float32)).to(kv.dtype) * kv
    if return_state:
        return out, x[:, -1]
    return out


def rwkv6_block(x, lp, cfg):
    h = rmsnorm(x, lp["norm_att"])
    x = _residual(x + rwkv6_timemix(h, lp, cfg))
    h = rmsnorm(x, lp["norm_ffn"])
    return _residual(x + rwkv6_channelmix(h, lp))


def rwkv6_param_tree(cfg: ModelConfig) -> Params:
    return {**embed_param_specs(cfg),
            "blocks": rwkv6_param_specs(cfg),
            "final_norm": rmsnorm_spec(cfg.d_model)}


def rwkv6_backbone(params: Params, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Embedding-space input -> final-norm output: the parallel (chunked)
    forward of the loss path, every layer on ``wkv6`` at the model's
    chunk."""
    for i in range(cfg.n_layers):
        x = rwkv6_block(x, _layer(params["blocks"], i), cfg)
    return rmsnorm(x, params["final_norm"])


def rwkv6_loss(params, batch, cfg):
    x = embed(batch["tokens"], params)
    x = rwkv6_backbone(params, x, cfg)
    return chunked_softmax_xent(x, params["embedding"], batch["labels"],
                                cfg.loss_chunk, unroll=cfg.unroll_layers)


def rwkv6_state_specs(cfg: ModelConfig, batch: int) -> Params:
    dims = rwkv6_dims(cfg)
    L = cfg.n_layers
    return {
        "wkv": ParamSpec((L, batch, dims["h"], dims["p"], dims["p"]),
                         torch.float32, ("layers", "batch", "tp", None, None),
                         init="zeros"),
        "prev_att": ParamSpec((L, batch, cfg.d_model), torch.bfloat16,
                              ("layers", "batch", None), init="zeros"),
        "prev_ffn": ParamSpec((L, batch, cfg.d_model), torch.bfloat16,
                              ("layers", "batch", None), init="zeros"),
        "index": ParamSpec((batch,), torch.int32, ("batch",), init="zeros"),
    }


def rwkv6_decode_step(params, state, tokens, cfg):
    """One token for every row: tokens (b, 1) -> (logits (b, V), state).
    Every leaf of ``state`` is updated in place and the tree handed back;
    each layer's WKV state is the ``wkv6`` kernel's own output."""
    x = embed(tokens, params)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        wkv, pa, pf = (state[key][i] for key in ("wkv", "prev_att",
                                                 "prev_ffn"))
        h = rmsnorm(x, lp["norm_att"])
        att, _, pa_new = rwkv6_timemix(h, lp, cfg, state=wkv, prev=pa,
                                       return_state=True, state_out=wkv)
        x = _residual(x + att)
        h = rmsnorm(x, lp["norm_ffn"])
        ffn, pf_new = rwkv6_channelmix(h, lp, prev=pf, return_state=True)
        x = _residual(x + ffn)
        pa.copy_(pa_new)
        pf.copy_(pf_new)
    x = rmsnorm(x, params["final_norm"])
    logits = logits_last(x, params["embedding"])
    state["index"].add_(1)
    return logits, state


# ===========================================================================
# Zamba2 hybrid
# ===========================================================================


def zamba2_param_tree(cfg: ModelConfig) -> Params:
    shared = {
        "norm_attn": rmsnorm_spec(cfg.d_model),
        "norm_mlp": rmsnorm_spec(cfg.d_model),
        "attn": attention_param_specs(cfg, layers=0),
        "mlp": mlp_param_specs(cfg, layers=0),
        "down": ParamSpec((2 * cfg.d_model, cfg.d_model), torch.bfloat16,
                          ("fsdp", "tp")),
    }
    return {**embed_param_specs(cfg),
            "mamba": mamba2_param_specs(cfg, cfg.n_layers),
            "shared": shared,
            "final_norm": rmsnorm_spec(cfg.d_model)}


def _zamba_shared_block(x, emb0, sp, cfg):
    """Shared attention block: concat(hidden, first-layer embedding) ->
    down-projection -> attn -> mlp (zamba2 concat re-use trick)."""
    cat = torch.cat([x, emb0], dim=-1)
    h = bmm(cat, sp["down"])
    a = rmsnorm(h, sp["norm_attn"])
    h = h + attention(a, sp["attn"], cfg, causal=True)
    a = rmsnorm(h, sp["norm_mlp"])
    h = h + mlp(a, sp["mlp"], cfg)
    return _residual(x + h)


def _groups(cfg: ModelConfig):
    """(group, [layer indices]) of the Mamba2 stack, one shared-block
    application after each group."""
    period = cfg.shared_attn_period
    return [(g, range(g * period, (g + 1) * period))
            for g in range(cfg.n_layers // period)]


def zamba2_backbone(params: Params, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Embedding-space input -> final-norm output: the parallel (chunked)
    forward of the loss path, every Mamba2 layer on ``ssd_chunk`` at the
    model's chunk."""
    emb0 = x
    for _, layers in _groups(cfg):
        for i in layers:
            lp = _layer(params["mamba"], i)
            x = _residual(x + mamba2_forward(rmsnorm(x, lp["norm"]), lp,
                                             cfg))
        x = _zamba_shared_block(x, emb0, params["shared"], cfg)
    return rmsnorm(x, params["final_norm"])


def zamba2_loss(params, batch, cfg):
    x = embed(batch["tokens"], params)
    x = zamba2_backbone(params, x, cfg)
    return chunked_softmax_xent(x, params["embedding"], batch["labels"],
                                cfg.loss_chunk, unroll=cfg.unroll_layers)


def zamba2_state_specs(cfg: ModelConfig, batch: int, max_len: int,
                       long_context: bool = False) -> Params:
    dims = mamba2_dims(cfg)
    L = cfg.n_layers
    n_apps = L // cfg.shared_attn_period
    seq_ax = "seq_full" if long_context else "seq_tp"
    kv_shape = (n_apps, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    kv_axes = ("layers", "batch", seq_ax, None, None)
    return {
        "ssm": ParamSpec((L, batch, dims["n_heads"], dims["d_state"],
                          dims["p"]), torch.float32,
                         ("layers", "batch", "tp", None, None), init="zeros"),
        "conv": ParamSpec((L, batch, 3, dims["conv_dim"]), torch.bfloat16,
                          ("layers", "batch", None, "tp"), init="zeros"),
        "kv": {
            "k": ParamSpec(kv_shape, torch.bfloat16, kv_axes, init="zeros"),
            "v": ParamSpec(kv_shape, torch.bfloat16, kv_axes, init="zeros"),
        },
        "index": ParamSpec((batch,), torch.int32, ("batch",), init="zeros"),
    }


def zamba2_decode_step(params, state, tokens, cfg):
    """One token for every row: tokens (b, 1) -> (logits (b, V), state).
    Every leaf of ``state`` is updated in place and the tree handed back."""
    x = embed(tokens, params)
    emb0 = x
    index = state["index"]
    sp = params["shared"]
    for g, layers in _groups(cfg):
        for i in layers:
            lp = _layer(params["mamba"], i)
            ssm_l, conv_l = state["ssm"][i], state["conv"][i]
            y, s2, c2 = mamba2_step(rmsnorm(x, lp["norm"]), lp, cfg, ssm_l,
                                    conv_l)
            ssm_l.copy_(s2)
            conv_l.copy_(c2)
            x = _residual(x + y)
        # shared attention with its per-application KV cache
        cat = torch.cat([x, emb0], dim=-1)
        h = bmm(cat, sp["down"])
        a = rmsnorm(h, sp["norm_attn"])
        kv_l = {"k": state["kv"]["k"][g], "v": state["kv"]["v"][g]}
        att, _ = decode_attention(a, sp["attn"], cfg, kv_l, index)
        h = h + att
        a = rmsnorm(h, sp["norm_mlp"])
        h = h + mlp(a, sp["mlp"], cfg)
        x = _residual(x + h)
    x = rmsnorm(x, params["final_norm"])
    logits = logits_last(x, params["embedding"])
    index.add_(1)
    return logits, state
