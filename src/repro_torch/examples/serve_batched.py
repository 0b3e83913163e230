"""End-to-end serving driver: batched requests through a (smoke-scale)
assigned architecture, with the paper's simulated accelerator power report
for the work performed.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        [--arch starcoder2-3b] [--device cpu]

Counterpart of ``examples/serve_batched.py``.  The engine decodes on the
``ideal`` backend (no ``backend=``, as the reference example), on the GPU
unless ``--device cpu`` is given.  :func:`run` takes any config and
parameter tree (a full-width one too) and returns what :func:`main` prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, Optional, Sequence

import numpy as np

from .._device import DeviceLike, resolve_device
from ..configs import ARCHS, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..core import FlowReport, model_for, run_flow
from ..models import model_api
from ..roofline.analytic import forward_flops
from ..serve import EngineStats, Request, ServeEngine

SLOTS, MAX_LEN = 2, 64


@dataclasses.dataclass
class ServeBatchedResult:
    """The served requests and the session's energy under the paper's power
    model: ``macs`` token positions' worth of one-token forwards, priced at
    nominal rails (``base``) and at the flow's calibrated islands
    (``tuned``), both in joules."""
    reqs: List[Request]
    stats: EngineStats
    seconds: float
    prompt_tokens: int
    macs: float
    flow: FlowReport
    base: float
    tuned: float


def run(cfg: ModelConfig, params: Any, requests: int = 6, max_new: int = 6,
        device: DeviceLike = None) -> ServeBatchedResult:
    """Serve ``requests`` requests of ``max_new`` tokens (prompts of 2-5
    tokens from ``default_rng(0)``) on ``SLOTS`` slots, then price the
    session."""
    engine = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         device=device)
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(requests):
        prompt = rng.integers(3, cfg.vocab_size, rng.integers(2, 6)).tolist()
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
        engine.submit(reqs[-1])
    t0 = time.time()
    stats = engine.run_until_drained()
    dt = time.time() - t0

    # the paper's power model for the serving work just performed: token
    # positions processed = absorbed prompt tokens (batch-1 prefill) + SLOTS
    # a batched decode step, each priced at the one-token batch-1 forward
    per_tok_shape = ShapeConfig("serve", MAX_LEN, 1, "decode")
    prompt_toks = sum(len(r.prompt) for r in reqs)
    macs = forward_flops(cfg, per_tok_shape) / 2 \
        * (prompt_toks + SLOTS * stats.decode_steps)
    flow = run_flow(array_n=16, tech="vtr-22nm", algo="dbscan", seed=2021)
    pm = model_for("vtr-22nm")
    frac = np.bincount(flow.labels, minlength=flow.n_partitions) \
        / flow.labels.size
    base = pm.macs_energy_j(macs, [pm.tech.v_nom] * flow.n_partitions, frac)
    tuned = pm.macs_energy_j(macs, flow.runtime_v, frac)
    return ServeBatchedResult(reqs=reqs, stats=stats, seconds=dt,
                              prompt_tokens=prompt_toks, macs=macs,
                              flow=flow, base=base, tuned=tuned)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2-3b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = model_api(cfg, device=dev).init_params(0)
    out = run(cfg, params, args.requests, args.max_new, device=dev)
    stats = out.stats
    print(f"served {stats.completed} requests / {stats.tokens_generated} "
          f"tokens in {stats.prefill_steps} prefill + {stats.decode_steps} "
          f"decode model steps, {out.seconds:.1f}s")
    for r in out.reqs[:3]:
        print(f"  req {r.uid}: {r.prompt} -> {r.out_tokens}")

    print(f"\nsimulated accelerator energy for this serving session "
          f"(paper's voltage-scaled partitioning, vtr-22nm):")
    print(f"  nominal rails: {out.base * 1e3:.3f} mJ")
    print(f"  calibrated voltage islands: {out.tuned * 1e3:.3f} mJ "
          f"({100 * (1 - out.tuned / out.base):.1f}% saved)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
