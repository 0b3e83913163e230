"""The benchmark's own count of operations and bytes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), the
bound of a GEMM on B1 (``systolic_mac``), and the model's FLOPs.  What a
model family needs for one token (its weight GEMMs and the FLOPs of an
attention pair) comes from that family's plain reference,
``bench/reference/<family>.py``, as its ``counts(config)``; a family
added later brings its counts in its own file.  The counts follow from the
configuration's shapes and the call's rows alone, never from what
implements a kernel:

* a GEMM's bound is ``max(bytes / HBM, 2 M K N / peak)``, each input byte
  read once (bf16 operands) and the f32 product written once (B1 returns
  its product in f32); the flag grid it also writes is left out (at most
  M N / 256 words);
* model FLOPs are ``2 M K N`` over every GEMM the model needs, plus the
  attention products (causal pairs only) and whatever per-token FLOPs the
  family's counts add (``row_flops(seq)``, none for the dense family); a
  train step is three forward passes.  Recomputation under ``remat`` is
  not the model's need and is not counted there.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

PEAK_BF16 = 989e12      # FLOP/s, tensor cores, dense
HBM_BYTES_PER_S = 3.35e12

Gemm = Tuple[int, int, int]   # (M, K, N)


def gemm_bound_s(m: int, k: int, n: int, in_bytes: int = 2,
                 out_bytes: int = 4) -> float:
    ops = 2.0 * m * k * n
    nbytes = in_bytes * (m * k + k * n) + out_bytes * m * n
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16)


def _pad(v: int, multiple: int = 256) -> int:
    return (v + multiple - 1) // multiple * multiple


class Yardstick:
    """Counts for one configuration (a ``ModelConfig``, or its fields as a
    plain mapping)."""

    def __init__(self, cfg) -> None:
        from .manifest import load_module
        c = cfg if isinstance(cfg, dict) else dataclasses.asdict(cfg)
        counts = load_module("reference", c["family"]).counts(c)
        self.gemms: List[Tuple[int, int, bool]] = \
            [tuple(g) for g in counts["gemms"]]
        self.pair_flops = float(counts["pair_flops"])
        self._row_flops = counts.get("row_flops", lambda seq: 0.0)
        self.d = c["d_model"]
        self.vocab = _pad(c["vocab_size"])
        self.loss_chunk = c["loss_chunk"]

    def _ce_chunks(self, b: int, s: int) -> List[int]:
        ch = min(self.loss_chunk, s)
        if s % ch:
            ch = s
        return [b * ch] * (s // ch)

    # ---- B1 calls of a model call ------------------------------------------

    def b1_calls(self, call: Tuple) -> List[Gemm]:
        """The (M, K, N) of every GEMM a model call hands B1: ``("decode",
        rows)``, ``("prefill", length)``, ``("loss", b, s)``, ``("train",
        b, s)`` (the loss's forward, the remat heads again)."""
        kind = call[0]
        if kind == "decode":
            m = call[1]
            return [(m, k, n) for k, n, _ in self.gemms] \
                + [(m, self.d, self.vocab)]
        if kind == "prefill":
            m = call[1]
            return [(m, k, n) for k, n, _ in self.gemms] \
                + [(1, self.d, self.vocab)]
        if kind in ("loss", "train"):
            b, s = call[1], call[2]
            m = b * s
            out = [(m, k, n) for k, n, _ in self.gemms]
            out += [(mc, self.d, self.vocab) for mc in self._ce_chunks(b, s)]
            if kind == "train":
                out += [(m, k, n) for k, n, head in self.gemms if head]
            return out
        raise ValueError(f"unknown call {call!r}")

    def b1_bound_s(self, calls: Iterable[Tuple]) -> float:
        return sum(gemm_bound_s(*g) for c in calls for g in self.b1_calls(c))

    # ---- model FLOPs -------------------------------------------------------

    def gemm_flops_per_row(self) -> float:
        return sum(2.0 * k * n for k, n, _ in self.gemms)

    def logits_flops_per_row(self) -> float:
        return 2.0 * self.d * self.vocab

    def forward_flops(self, b: int, s: int) -> float:
        """A forward pass with logits at every position (the loss)."""
        rows = b * s
        pairs = b * s * (s + 1) / 2.0
        return (rows * (self.gemm_flops_per_row() + self.logits_flops_per_row()
                        + self._row_flops(s))
                + pairs * self.pair_flops)

    def prefill_flops(self, length: int) -> float:
        """A prompt of ``length`` tokens, logits at its last position."""
        return (length * (self.gemm_flops_per_row() + self._row_flops(length))
                + self.logits_flops_per_row()
                + length * (length + 1) / 2.0 * self.pair_flops)

    def decode_token_flops(self, keys: int) -> float:
        """One decoded token attending ``keys`` cached positions."""
        return (self.gemm_flops_per_row() + self.logits_flops_per_row()
                + self._row_flops(1) + keys * self.pair_flops)

    def train_flops(self, b: int, s: int) -> float:
        return 3.0 * self.forward_flops(b, s)
