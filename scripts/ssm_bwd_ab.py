"""Device time of the SSM backward kernels in two trees on one card: a
parent tree against this one, in turns (parent, this, this with
ssd_chunk at one head a block, this, parent).

Each turn is a process of its own that imports ``repro_torch`` from its
tree (and ``chip_smoke.py``'s helpers from this one), builds that tree's
kernels, and times one backward call of ``ssd_chunk`` (zamba2-2.7b: h 80, p
64, n 64), ``wkv6`` and bf16 ``wkv6`` (rwkv6-1.6b: h 32, p 64) at the train
(2 x 256) and loss (2 x 2048) shapes, chunk 64, the state gradient zero:
milliseconds back to back by CUDA events, device ms and launches by kernel
by ``torch.profiler``.  Needs an NVIDIA GPU and ``nvcc``.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/ssm_bwd_ab.py --parent build/parent   # all turns
    python3 scripts/ssm_bwd_ab.py --tree build/parent      # one turn

Rows go to standard output and, for all turns, to
``chiprun_out/ssm_bwd_ab.jsonl``.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = (("train", 2, 256), ("loss", 2, 2048))


def turn(tree: str, heads_per_block: int) -> None:
    """One tree's rows (``heads_per_block``: ssd_chunk's grouping, 0 for
    the tree's own plan and then every kernel)."""
    sys.path[:0] = [str(Path(tree).resolve() / "src"), str(ROOT)]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import ssd_chunk as smod
    from repro_torch.kernels.wkv6 import wkv6
    assert smod.__file__.startswith(os.path.abspath(tree)), smod.__file__
    if heads_per_block:
        smod.pass_plan = lambda *a: smod.PassPlan(*a, heads_per_block)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)

    def row(kind, fn, args, shape):
        leaves = [a.detach().requires_grad_(True) for a in args]
        y, S = fn(*leaves, chunk=64)
        dy = torch.randn(y.shape, generator=gen, device="cuda")
        dS = torch.zeros_like(S)

        def bwd():
            return torch.autograd.grad((y, S), leaves, (dy, dS),
                                       retain_graph=True)
        iters = 5
        ms = cs.time_ms(lambda i: bwd(), 1, iters)
        prof = cs.profile_calls(
            torch, {kind: lambda: [bwd() for _ in range(iters)]},
            repeats=iters)[kind] or []
        passes = {r["kernel"]: r["ms"] / iters for r in prof
                  if "_bwd_" in r["kernel"]}
        print(json.dumps({
            "tree": tree, "heads_per_block": heads_per_block or None,
            "kernel": kind, "shape": shape, "ms": ms,
            "device_ms": sum(passes.values()) if passes else None,
            "launches": sum(r["calls"] for r in prof
                            if "_bwd_" in r["kernel"]) / iters,
            "device_ms_by_pass": passes}), flush=True)

    for shape, b, s in SHAPES:
        row("ssd_chunk_bwd", smod.ssd_chunk,
            cs.ssd_inputs(torch, gen, b, s, 80, 64, 64, True), shape)
        if heads_per_block:
            continue
        row("wkv6_bwd", wkv6, cs.wkv6_inputs(torch, gen, b, s, 32, 64, 0.5,
                                             True), shape)
        row("wkv6_bwd_bf16", wkv6,
            cs.wkv6_bf16_inputs(torch, gen, b, s, 32, 64, False), shape)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent tree: run every turn")
    ap.add_argument("--tree", help="one turn, this tree's kernels")
    ap.add_argument("--heads-per-block", type=int, default=0)
    args = ap.parse_args()
    if args.tree:
        turn(args.tree, args.heads_per_block)
        return 0
    if not args.parent:
        ap.error("--parent or --tree")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    failed = 0
    with open(out_dir / "ssm_bwd_ab.jsonl", "w") as out:
        out.write(json.dumps({"device": smi}) + "\n")
        for tree, g in ((args.parent, 0), (str(ROOT), 0), (str(ROOT), 1),
                        (str(ROOT), 0), (args.parent, 0)):
            done = subprocess.run(
                [sys.executable, __file__, "--tree", tree,
                 "--heads-per-block", str(g)], capture_output=True, text=True)
            sys.stdout.write(done.stdout)
            sys.stderr.write(done.stderr[-4000:])
            out.write(done.stdout)
            failed += done.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
