"""End-to-end training driver: a ~100M-parameter decoder LM for a few hundred
steps, with checkpoint/restart and the heartbeat monitor attached.

The default scale is small (~20M params, 100 steps); pass
--d-model 768 --layers 12 --steps 300 for the full ~100M x 300-step run.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 100] \
        [--device cpu]

Counterpart of ``examples/train_lm.py``: phi4-mini's smoke config cut to the
flags' width and depth, trained by ``repro_torch.train.train`` on the GPU
unless ``--device cpu`` is given.  :func:`run` takes ``init=`` (the first
parameters from the model's API) and returns what :func:`main` prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Callable, Optional, Sequence

from .. import optim
from .._device import DeviceLike, resolve_device
from ..configs import get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..runtime import HeartbeatMonitor
from ..train import TrainConfig, TrainResult, train

#: the reference example's default checkpoint directory, under this
#: process's temporary directory
DEFAULT_CHECKPOINT_DIR = os.path.join(tempfile.gettempdir(),
                                      "repro_train_lm")


@dataclasses.dataclass
class TrainLMResult:
    cfg: ModelConfig
    n_params: int
    res: TrainResult
    monitor: HeartbeatMonitor
    checkpoint_dir: str


def lm_config(d_model: int = 256, layers: int = 4) -> ModelConfig:
    """phi4-mini's smoke config at ``layers`` x ``d_model``: heads of 64,
    ``d_ff = 4 d``, an 8192-token vocabulary, attention and loss chunks of
    64."""
    return dataclasses.replace(
        get_config("phi4-mini-3.8b", smoke=True),
        n_layers=layers, d_model=d_model,
        n_heads=d_model // 64, n_kv_heads=max(d_model // 128, 1),
        d_head=64, d_ff=4 * d_model, vocab_size=8192,
        attn_chunk=64, loss_chunk=64)


def n_params_of(cfg: ModelConfig) -> int:
    """The reference example's parameter count: the embedding and each
    layer's attention and MLP weights."""
    return (cfg.vocab_size * cfg.d_model
            + cfg.n_layers * (2 * cfg.d_model * cfg.q_dim
                              + 2 * cfg.d_model * cfg.kv_dim
                              + 3 * cfg.d_model * cfg.d_ff))


def run(cfg: ModelConfig, steps: int = 100, batch: int = 4, seq: int = 128,
        checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR, *,
        device: DeviceLike = None, init: Optional[Callable] = None
        ) -> TrainLMResult:
    """``steps`` AdamW steps (lr 3e-3, a tenth of them warm-up) of
    ``batch`` x ``seq`` tokens, a checkpoint every quarter of the run."""
    monitor = HeartbeatMonitor(num_hosts=1)
    res = train(cfg,
                ShapeConfig("example", seq, batch, "train"),
                TrainConfig(steps=steps, log_every=10,
                            checkpoint_every=max(steps // 4, 1),
                            checkpoint_dir=checkpoint_dir),
                optim.AdamWConfig(lr=3e-3, warmup_steps=max(steps // 10, 1),
                                  total_steps=steps),
                monitor=monitor, device=device, init=init)
    return TrainLMResult(cfg=cfg, n_params=n_params_of(cfg), res=res,
                         monitor=monitor, checkpoint_dir=checkpoint_dir)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = lm_config(args.d_model, args.layers)
    print(f"training {n_params_of(cfg) / 1e6:.1f}M-param decoder LM "
          f"({cfg.n_layers}L d={cfg.d_model}) for {args.steps} steps")
    out = run(cfg, args.steps, args.batch, args.seq, args.checkpoint_dir,
              device=dev)
    res, monitor = out.res, out.monitor
    print(f"\nloss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} over "
          f"{res.steps_done} steps ({res.wall_s:.1f}s); stragglers: "
          f"{[r.host_id for r in monitor.stragglers()]}")
    print(f"checkpoints in {args.checkpoint_dir} (resume with the same "
          f"command)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
