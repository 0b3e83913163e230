"""Training launcher.  Counterpart of ``repro.launch.train`` with the same
flags, plus ``--device`` and ``--backend``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --smoke --steps 4 --device cpu

It runs on the GPU; ``--device cpu`` is for machines without one (with
``--smoke``).  The loop is data -> train_step -> checkpoints -> fault
monitor, and every GEMM goes through ``--backend`` (``ideal``, the
default, is ``torch.matmul``; ``reference`` runs each forward GEMM on the
``systolic_mac`` kernel with straight-through gradients).  It prints the
reference's ``done: ...`` line.
"""

from __future__ import annotations

import argparse

from .. import optim
from ..backend import get_backend, use_backend
from ..configs import ARCHS, get_config
from ..configs.base import ShapeConfig
from ..runtime import HeartbeatMonitor
from ..train import TrainConfig, train


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--int8-moments", action="store_true",
                    help="compressed optimizer state")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the model trains (default: the GPU)")
    ap.add_argument("--backend", default="ideal",
                    choices=("ideal", "reference"),
                    help="execution backend for every model GEMM")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tc = TrainConfig(steps=args.steps, checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every)
    oc = optim.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 20, 1),
                           int8_moments=args.int8_moments)
    monitor = HeartbeatMonitor(num_hosts=1)
    with use_backend(get_backend(args.backend, device=args.device)):
        res = train(cfg, shape, tc, oc, monitor=monitor, resume=args.resume,
                    device=args.device)
    print(f"done: {res.steps_done} steps in {res.wall_s:.1f}s; "
          f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}")


if __name__ == "__main__":
    main()
