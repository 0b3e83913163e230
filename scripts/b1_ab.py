"""Device time of B1 (``systolic_mac``) in two trees on one card: a parent
tree against this one, in turns (parent, this, this, parent), then this
tree's two forms side by side at M = 16..512 (the crossover).

Each turn is a process of its own that imports ``repro_torch`` from its
tree (and ``chip_smoke.py``'s helpers from this one), builds that tree's
kernels, and times B1 as the reference backend launches it (nominal rails
on ``largest_common_block``'s grid, ``counter=``), each weight cold in L2,
on three paths:

* ``llava_prefill``: llava-next-mistral-7b's prefill GEMMs at M = 2944 (7 a
  layer, 32 layers; the logits at M = 1, the last row);
* ``phi4_train``: a phi4-mini-3.8b train step's 417 GEMMs at M = 512;
* ``phi4_decode``: a phi4-mini-3.8b decode step's 225 GEMMs at M = 4.

A row is one weight: device ms a call by ``torch.profiler`` (kernel and
memset rows summed), ms a call back to back by CUDA events, the launches a
path makes of it; a ``total`` row sums a path over its launches.  The
crossover turn times phi4-mini's weights at M = 16, 32, 64, 96, 128, 192,
256 and 512 in each form (``WIDE_FROM_M`` moved so that one form runs).
Needs an NVIDIA GPU and ``nvcc``.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/b1_ab.py --parent build/parent     # every turn
    python3 scripts/b1_ab.py --tree build/parent       # one turn
    python3 scripts/b1_ab.py --crossover               # this tree's forms

Rows go to standard output and, for all turns, to
``chiprun_out/b1_ab.jsonl``.
"""

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PREFILL_M, TRAIN_M, DECODE_M = 2944, 512, 4
CROSSOVER_MS = (16, 32, 64, 96, 128, 192, 256, 512)


def timer(tree: str):
    """(torch, time one weight) with ``repro_torch`` from ``tree``."""
    sys.path[:0] = [str(Path(tree).resolve() / "src"), str(ROOT)]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.backend.base import largest_common_block
    from repro_torch.kernels import systolic_mac as smod
    assert smod.__file__.startswith(os.path.abspath(tree)), smod.__file__
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)

    def weight_ms(m, k, n, transposed):
        """(device ms, ms) of one call at (m, k) x (k, n), cold weights."""
        dt = torch.bfloat16
        copies = max(1, math.ceil(120e6 / (2 * k * n)))
        if transposed:
            store = torch.randn((copies, n, k), generator=gen,
                                device="cuda").mul_(0.02).to(dt)
            bs = [store[i].T for i in range(copies)]
        else:
            store = torch.randn((copies, k, n), generator=gen,
                                device="cuda").mul_(1 / math.sqrt(k)).to(dt)
            bs = [store[i] for i in range(copies)]
        a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        block = largest_common_block(m, n)
        v_map = torch.ones((m // block, n // block), device="cuda")
        v_safe = torch.zeros_like(v_map)
        counter = torch.zeros((), dtype=torch.int32, device="cuda")

        def call(i):
            return smod.systolic_mac(a, bs[i], v_map, v_safe, block_m=block,
                                     block_n=block, counter=counter)
        iters = max(4, min(24, int(2e10 // (2 * m * k * n + 1))))
        out = (cs.device_ms(call, copies, iters),
               cs.time_ms(call, copies, iters))
        del store, bs, a
        return out
    return torch, cs, smod, weight_ms


def paths(cs):
    """path -> (M, {weight: (K, N, launches, transposed view?)})."""
    from repro_torch.configs import get_config
    phi4 = get_config("phi4-mini-3.8b")
    llava = get_config("llava-next-mistral-7b")

    def table(gemms):
        return {name: (k, n, per, t) for name, (k, n, per, t, _)
                in gemms.items()}
    return {"llava_prefill": (PREFILL_M, table(cs.dense_gemms(llava))),
            "phi4_train": (TRAIN_M, table(cs.train_gemms(phi4))),
            "phi4_decode": (DECODE_M, table(cs.dense_gemms(phi4)))}


def emit(row):
    print(json.dumps(row), flush=True)


def turn(tree: str) -> None:
    """One tree's rows on the three paths."""
    torch, cs, smod, weight_ms = timer(tree)
    for path, (m, weights) in paths(cs).items():
        total = {"device_ms": 0.0, "ms": 0.0}
        for name, (k, n, per, t) in weights.items():
            rows = 1 if (path == "llava_prefill" and name == "logits") else m
            dev, ms = weight_ms(rows, k, n, t)
            emit({"tree": tree, "path": path, "weight": name, "M": rows,
                  "K": k, "N": n, "launches": per, "device_ms": dev,
                  "ms": ms,
                  "row_tile": smod.row_tile(rows, 1)
                  if hasattr(smod, "row_tile") else smod.TILE_M})
            for key, v in (("device_ms", dev), ("ms", ms)):
                total[key] = None if (v is None or total[key] is None) \
                    else total[key] + per * v
        emit({"tree": tree, "path": path, "weight": "total", "M": m,
              "launches": sum(w[2] for w in weights.values()), **total})


def crossover() -> None:
    """This tree's two forms at phi4-mini's weights, M = CROSSOVER_MS."""
    torch, cs, smod, weight_ms = timer(str(ROOT))
    _, weights = paths(cs)["phi4_decode"]
    keep = smod.WIDE_FROM_M
    for m in CROSSOVER_MS:
        sums = {}
        for form, start in (("row16", 1 << 30), ("wide", 1)):
            smod.WIDE_FROM_M = start
            sums[form] = 0.0
            for name, (k, n, per, t) in weights.items():
                if name == "logits":
                    continue
                dev, ms = weight_ms(m, k, n, t)
                emit({"crossover": form, "weight": name, "M": m, "K": k,
                      "N": n, "launches": per, "device_ms": dev, "ms": ms})
                sums[form] = None if (dev is None or sums[form] is None) \
                    else sums[form] + per * dev
        smod.WIDE_FROM_M = keep
        emit({"crossover": "layer_sum", "M": m,
              "device_ms": sums, "wide_from_M": keep,
              "chosen": "wide" if smod.row_tile(m, 1) > smod.TILE_M
              else "row16"})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent tree: run every turn")
    ap.add_argument("--tree", help="one turn, this tree's kernels")
    ap.add_argument("--crossover", action="store_true",
                    help="this tree's two forms at M = 16..512")
    args = ap.parse_args()
    if args.tree:
        turn(args.tree)
        return 0
    if args.crossover and not args.parent:
        crossover()
        return 0
    if not args.parent:
        ap.error("--parent, --tree or --crossover")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    failed = 0
    with open(out_dir / "b1_ab.jsonl", "w") as out:
        out.write(json.dumps({"device": smi}) + "\n")
        for extra in (["--tree", args.parent], ["--tree", str(ROOT)],
                      ["--tree", str(ROOT)], ["--tree", args.parent],
                      ["--crossover"]):
            done = subprocess.run([sys.executable, __file__, *extra],
                                  capture_output=True, text=True)
            sys.stdout.write(done.stdout)
            sys.stderr.write(done.stderr[-4000:])
            out.write(done.stdout)
            failed += done.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
