"""The one traffic generator every driver reads its mix from.

A seed changes the order of the work, never its amount: lengths are fixed
quantiles of their distributions, and each block of ``block``
requests holds every quantile once, in an order drawn from the seed.  So
any run's first requests have nearly the same lengths whatever the seed,
and two seeds differ only in which request comes when and in the token
ids (drawn from the seed).

Parameters a traffic file may set (lengths are token counts):

* ``prompt``: ``[lo, hi]``, log-uniform; ``output``: ``[lo, hi]``,
  log-uniform (served mixes);
* ``block``: requests per block of quantiles (default 64);
* ``arrival``: ``"closed"`` with ``clients`` (each sends its next request
  when its last one finishes), the one arrival process there is;
* ``batch``, ``seq``: rows and tokens of a scored or trained batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

#: salt that keeps the fixed pairing of lengths apart from any seed
_PAIRING = 0x5EED


def quantiles_loguniform(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integers at the mid-quantiles of log-uniform on [lo, hi]."""
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                   ).astype(np.int64)


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(x) & (2 ** 64 - 1)
                                  for x in (seed, *salt)])


@dataclasses.dataclass
class Spec:
    prompt_len: int
    max_new: int
    tokens: List[int]


class RequestStream:
    """An endless stream of served requests for one seed."""

    def __init__(self, seed: int, traffic: Dict, vocab: int) -> None:
        self.seed = seed
        self.block = int(traffic.get("block", 64))
        prompts = quantiles_loguniform(*traffic["prompt"], self.block)
        outs = quantiles_loguniform(*traffic["output"], self.block)
        # one fixed pairing of prompt and output quantiles, for every seed
        pair = np.random.default_rng(_PAIRING).permutation(self.block)
        self.pairs = list(zip(prompts.tolist(), outs[pair].tolist()))
        self.vocab = vocab
        if traffic.get("arrival", "closed") != "closed":
            raise ValueError(f"arrival {traffic['arrival']!r}: only a "
                             "closed loop is generated")
        self._tok = rng(seed, 1)
        self._n = 0
        self._order: List[int] = []

    def __iter__(self) -> Iterator[Spec]:
        return self

    def __next__(self) -> Spec:
        i = self._n % self.block
        if i == 0:
            k = self._n // self.block
            self._order = rng(self.seed, 2, k).permutation(self.block).tolist()
        plen, out = self.pairs[self._order[i]]
        tokens = self._tok.integers(0, self.vocab, plen).tolist()
        self._n += 1
        return Spec(plen, out, tokens)


def batch_rows(seed: int, index: int, batch: int, seq: int, vocab: int,
               device) -> Tuple["torch.Tensor", "torch.Tensor"]:
    """Batch ``index`` of a scored or trained stream: (tokens, labels), each
    (batch, seq) int32 on ``device``, the labels the next tokens.  Drawn on
    the device from (seed, index) alone, so the reference can draw it
    again."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, 4, index).integers(0, 2 ** 62)))
    ids = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                        device=device, dtype=torch.int64)
    return (ids[:, :-1].to(torch.int32).contiguous(),
            ids[:, 1:].to(torch.int32).contiguous())


def sample(seed: int, n_items: int, k: int, always: Optional[int] = None
           ) -> List[int]:
    """``k`` indices of ``n_items`` drawn from the seed, ``always`` among
    them."""
    picks = rng(seed, 5).permutation(n_items).tolist()
    chosen = [] if always is None else [always]
    for i in picks:
        if len(chosen) >= k:
            break
        if i not in chosen:
            chosen.append(i)
    return sorted(chosen)
