"""Plain PyTorch reference of the dense decoder (phi4-mini-3.8b), in
float32 with TF32 off.

The model the port computes, as it computes it (``repro_torch`` is not
imported; these are its equations written out again):

* tied embedding (``embedding``, (vocab padded, d)): the input rows, and
  the logits ``x @ embedding.T`` over every padded row;
* per layer: ``x += attn(rmsnorm(x))``, ``x += mlp(rmsnorm(x))``, RMSNorm
  with eps 1e-6 and an f32 scale, then a final RMSNorm;
* attention: q, k, v projections, rotary embedding over the whole head
  (theta ``rope_theta``, the two halves rotated), grouped-query heads, a
  causal softmax scaled by ``1/sqrt(d_head)``, the output projection;
* MLP: SwiGLU, ``(silu(x @ wg) * (x @ w1)) @ w2``.

The port rounds activations to bf16 between its operations; the reference
keeps every activation in float32 on the bf16 weights read exactly.

Every GEMM goes through one product ``mm``: ``"f32"`` is the reference;
``"int8"`` and ``"fp8"`` round both operands to an 8-bit grid first (rows
of the activations, columns of the weights), the controls one precision
below the configuration's bf16.  The attention products stay in f32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6


def counts(c: Dict) -> Dict:
    """What the benchmark's yardstick (``bench/harness/yardstick.py``)
    counts of this family, from the configuration's fields ``c``:

    * ``gemms``: every weight GEMM of one token's forward pass but the
      logits, as ``(K, N, head)``: ``head`` where the GEMM belongs to a
      block's head, which ``remat`` runs again in the backward pass (q, k,
      v, o and the MLP's gate and up projections; the down projection
      ends the block);
    * ``pair_flops``: FLOPs of one causal query and key pair over every
      attention layer: ``q k`` and ``p v``, ``2 * 2 * heads * d_head``
      each layer.
    """
    d, ff = c["d_model"], c["d_ff"]
    qd, kvd = c["n_heads"] * c["d_head"], c["n_kv_heads"] * c["d_head"]
    block = [(d, qd, True), (d, kvd, True), (d, kvd, True), (qd, d, True),
             (d, ff, True), (d, ff, True), (ff, d, False)]
    return {"gemms": block * c["n_layers"],
            "pair_flops": 4.0 * c["n_heads"] * c["d_head"] * c["n_layers"]}


class _Round(torch.autograd.Function):
    """Round to an 8-bit grid (``int8``: symmetric integers; ``fp8``:
    e4m3), one scale per slice along ``dim``; the gradient passes straight
    through."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        if kind == "int8":
            scale = amax / 127
            return torch.clamp(torch.round(x / scale), -127, 127).mul_(scale)
        scale = amax / 448
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype).mul_(scale)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None, None


def product(precision: str) -> Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor]:
    """``a @ b`` in ``precision``: ``"f32"``, or ``"int8"`` / ``"fp8"``
    (both operands rounded first: a's rows, b's columns)."""
    if precision == "f32":
        return torch.matmul
    if precision in ("int8", "fp8"):
        return lambda a, b: torch.matmul(_Round.apply(a, -1, precision),
                                         _Round.apply(b, 0, precision))
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) \
        * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, s, heads, d_head); pos: (s,)."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], c: Dict,
              mm, q_chunk: int = 1024) -> torch.Tensor:
    """Causal grouped-query attention over x: (b, s, d)."""
    b, s, _ = x.shape
    h, kv, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    pos = torch.arange(s, device=x.device)
    q = rope(mm(x, w["wq"]).view(b, s, h, dh), pos, c["rope_theta"])
    k = rope(mm(x, w["wk"]).view(b, s, kv, dh), pos, c["rope_theta"])
    v = mm(x, w["wv"]).view(b, s, kv, dh)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    outs = []
    for q0 in range(0, s, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, k) / math.sqrt(dh)
        qpos = pos[q0:q0 + q_chunk]
        scores = scores.masked_fill(pos[None, :] > qpos[:, None],
                                    float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v))
    o = torch.cat(outs, dim=1).reshape(b, s, h * dh)
    return mm(o, w["wo"])


def block(x: torch.Tensor, w: Dict, c: Dict, mm) -> torch.Tensor:
    x = x + attention(rmsnorm(x, w["norm_attn"]), w["attn"], c, mm)
    h = rmsnorm(x, w["norm_mlp"])
    m = w["mlp"]
    return x + mm(F.silu(mm(h, m["wg"])) * mm(h, m["w1"]), m["w2"])


def _layer(blocks: Dict, i: int) -> Dict:
    """Layer ``i`` of the stacked bf16 tree, as float32."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i].float())
            for k, v in blocks.items()}


def logits_at(w: Dict, c: Dict, seqs: Sequence[torch.Tensor],
              wanted: Sequence[torch.Tensor],
              precision: str = "f32") -> List[torch.Tensor]:
    """The logits (len(wanted[i]), vocab) at positions ``wanted[i]`` of each
    token sequence ``seqs[i]`` (1-D), layer by layer over all sequences
    (one layer's weights in float32 at a time)."""
    mm = product(precision)
    emb = w["embedding"]
    xs = [emb[s.long()].float()[None] for s in seqs]
    for i in range(c["n_layers"]):
        lw = _layer(w["blocks"], i)
        xs = [block(x, lw, c, mm) for x in xs]
        del lw
    out = []
    emb_t = emb.float().T
    for x, pos in zip(xs, wanted):
        hf = rmsnorm(x[0, pos.long()], w["final_norm"].float())
        out.append(mm(hf, emb_t))
    return out


def mean_xent(x: torch.Tensor, emb_t: torch.Tensor, labels: torch.Tensor,
              mm, rows: int = 1024) -> torch.Tensor:
    """Mean over rows of ``logsumexp(x @ emb_t) - gold``, in blocks of rows
    (x: (n, d), labels: (n,))."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for r0 in range(0, x.shape[0], rows):
        logits = mm(x[r0:r0 + rows], emb_t)
        gold = logits.gather(1, labels[r0:r0 + rows].long()[:, None])[:, 0]
        total = total + (torch.logsumexp(logits, -1) - gold).sum()
    return total / x.shape[0]


def loss(w: Dict, c: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         precision: str = "f32") -> float:
    """Mean next-token cross-entropy of a (b, s) batch, no gradient."""
    mm = product(precision)
    with torch.no_grad():
        x = w["embedding"][tokens.long()].float()
        for i in range(c["n_layers"]):
            x = block(x, _layer(w["blocks"], i), c, mm)
        x = rmsnorm(x, w["final_norm"].float())
        return float(mean_xent(x.reshape(-1, x.shape[-1]),
                               w["embedding"].float().T, labels.reshape(-1),
                               mm))


def train_loss(p: Dict, c: Dict, tokens: torch.Tensor, labels: torch.Tensor,
               precision: str = "f32") -> torch.Tensor:
    """The same loss on float32 leaves ``p`` (the stacked tree) under
    autograd: each stacked leaf is unbound once, each block checkpointed
    (the same numbers, held for fewer bytes)."""
    mm = product(precision)
    layers = [{} for _ in range(c["n_layers"])]

    def split(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                split(v, path + (k,))
                continue
            for i, t in enumerate(v.unbind(0)):
                d = layers[i]
                for key in path:
                    d = d.setdefault(key, {})
                d[k] = t
    split(p["blocks"], ())
    x = p["embedding"][tokens.long()]
    for lw in layers:
        # each block runs again in the backward pass: the int8 control's
        # rounded weights are never all held at once
        x = checkpoint(block, x, lw, c, mm, use_reentrant=False)
    x = rmsnorm(x, p["final_norm"])
    return mean_xent(x.reshape(-1, x.shape[-1]), p["embedding"].T,
                     labels.reshape(-1), mm)
