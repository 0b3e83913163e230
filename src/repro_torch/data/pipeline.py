"""Deterministic synthetic data pipeline.  The port's copy of
``repro.data.pipeline`` (numpy and the standard library): every batch is
byte-equal to the reference's, and batches stay numpy (the trainer puts them
on its device).

Stateless-hash token generation keyed by (seed, host, step): after a restart
(or an elastic remap onto fewer hosts) the pipeline replays bit-identically —
the property the fault-tolerance tests assert (DESIGN.md Sec. 7).

Features: document sampling + packing to fixed seq_len with EOS boundaries,
per-data-shard slicing of the global batch, background prefetch thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

EOS = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 17
    mean_doc_len: int = 512
    frontend: Optional[str] = None     # vision | audio | None
    frontend_tokens: int = 0
    d_model: int = 0
    enc_frames_ratio: int = 4


def _hash_u64(x: np.ndarray) -> np.ndarray:
    """splitmix64 — cheap stateless PRNG."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _tokens_for(cfg: DataConfig, sample_ids: np.ndarray) -> np.ndarray:
    """(n, seq_len) packed token ids for global sample indices."""
    n = len(sample_ids)
    s = cfg.seq_len
    pos = np.arange(s, dtype=np.uint64)[None, :]
    base = (sample_ids.astype(np.uint64)[:, None] * np.uint64(1_000_003)
            + np.uint64(cfg.seed) * np.uint64(0x51F1))
    h = _hash_u64(base + pos)
    toks = (h % np.uint64(max(cfg.vocab_size - 2, 1))).astype(np.int64) + 2
    # deterministic document boundaries -> EOS markers (packing)
    doc_h = _hash_u64(base + pos + np.uint64(0xABCDEF))
    eos_mask = (doc_h % np.uint64(cfg.mean_doc_len)) == 0
    toks[eos_mask] = EOS
    return toks


@dataclasses.dataclass
class Batch:
    step: int
    data: Dict[str, np.ndarray]


class SyntheticDataset:
    """Sharded deterministic stream: host ``shard`` of ``num_shards`` sees
    rows [shard * per_shard, (shard+1) * per_shard) of each global batch."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError("global batch must divide across shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.per_shard = cfg.global_batch // num_shards

    def batch_at(self, step: int) -> Batch:
        cfg = self.cfg
        start = step * cfg.global_batch + self.shard * self.per_shard
        ids = np.arange(start, start + self.per_shard, dtype=np.int64)
        toks = _tokens_for(cfg, ids)
        data: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1].astype(np.int32) if False else
            toks.astype(np.int32),
            "labels": np.roll(toks, -1, axis=1).astype(np.int32),
        }
        if cfg.frontend == "vision" and cfg.frontend_tokens:
            rng_h = _hash_u64(ids.astype(np.uint64)[:, None]
                              + np.uint64(0xBEEF) * np.arange(
                                  cfg.frontend_tokens, dtype=np.uint64)[None])
            emb = ((rng_h % np.uint64(2048)).astype(np.float32) / 1024.0 - 1.0)
            data["patch_embeds"] = np.repeat(
                emb[:, :, None], cfg.d_model, axis=2).astype(np.float32) * 0.02
        if cfg.frontend == "audio":
            t_enc = max(cfg.seq_len // cfg.enc_frames_ratio, 1)
            rng_h = _hash_u64(ids.astype(np.uint64)[:, None]
                              + np.uint64(0xF00D) * np.arange(
                                  t_enc, dtype=np.uint64)[None])
            emb = ((rng_h % np.uint64(2048)).astype(np.float32) / 1024.0 - 1.0)
            data["frames"] = np.repeat(
                emb[:, :, None], cfg.d_model, axis=2).astype(np.float32) * 0.02
        return Batch(step=step, data=data)

    def iterate(self, start_step: int = 0) -> Iterator[Batch]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """Background-thread prefetch over a SyntheticDataset."""

    def __init__(self, dataset: SyntheticDataset, start_step: int = 0,
                 depth: int = 2):
        self._ds = dataset
        self._q: "queue.Queue[Batch]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self._ds.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> Batch:
        return self._q.get()

    def __iter__(self):
        return self

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
