"""The bf16 wkv6 forward (B4 with bf16 r, k and v) in two trees on one
card: a parent tree against this one, in turns (parent, this, this,
parent), its device time by pass and its bits.

Each turn is a process of its own that imports ``repro_torch`` from its
tree (and ``chip_smoke.py``'s helpers from this one), builds that tree's
kernels, and

* times one ``wkv6`` call with bf16 r, k and v and one with their f32
  copies (the same values) at rwkv6-1.6b's loss shape (2 x 2048), its
  train shape (2 x 256; chunk 64, h 32, p 64) and a ragged chunk of 1000
  rows (1 x 1000): ms a call back to back by CUDA events, device ms by
  pass by ``torch.profiler``;
* hashes (SHA-256 of the bytes) y, the final state and the three passes'
  workspace (each chunk's incoming state, lw, the chunks' decays: what
  the backward kernel reads) of the bf16 kernel, taken both without and
  under autograd's kept passes, and y and the state of the f32 kernel on
  f32 copies of the same values, on ``chip_smoke.py``'s eight
  ``check_wkv6_bf16`` cases (``WKV6_BF16_CASES``, their seeded inputs) and
  on the operands one rwkv6-1.6b layer hands ``wkv6`` (full width, one
  layer, ``ssm_bf16=True``, random weights from seed 0, a seeded 2 x 2048
  batch on ``reference``), captured once from this tree into ``build/``.

The first process captures the layer's operands; the last compares every
turn's hashes with the first turn's and writes one ``bits`` row: each case
bit-equal between the trees or not.  Needs an NVIDIA GPU and ``nvcc``.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/wkv6_bf16_ab.py --parent build/parent   # every turn
    python3 scripts/wkv6_bf16_ab.py --tree build/parent     # one turn

Rows go to standard output and, for all turns, to
``chiprun_out/wkv6_bf16_ab.jsonl``.
"""

import argparse
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LAYER = ROOT / "build" / "wkv6_bf16_ab_layer.pt"
TIMED = (("loss", 2, 2048, 64), ("train", 2, 256, 64),
         ("ragged", 1, 1000, 1000))


def _imports(tree: str):
    sys.path[:0] = [str(Path(tree).resolve() / "src"), str(ROOT)]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import wkv6 as wmod
    assert wmod.__file__.startswith(os.path.abspath(tree)), wmod.__file__
    return torch, cs, wmod


def _ptxas(tree: str) -> None:
    """Registers and spills of wkv6.cu's kernels, where this process built
    the tree's library (an empty list where it found it built)."""
    from repro_torch.kernels import _build
    log = _build.build_log()
    log = log.split("--- nvcc wkv6.cu")[-1].split("--- ")[0] if log else ""
    print(json.dumps({"tree": tree, "ptxas_wkv6": [
        x.strip() for x in log.splitlines()
        if "entry function" in x or "spill" in x or "Used" in x]}),
        flush=True)


def capture() -> None:
    """One rwkv6-1.6b layer's wkv6 operands (bf16 r, k and v) into LAYER."""
    torch, cs, wmod = _imports(str(ROOT))
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    from repro_torch.models import ssm as ssm_mod
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=1,
                              ssm_bf16=True)
    api = model_api(cfg, backend="reference")
    params = api.init_params(cs.SEED)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 31)
    b, s = cs.LOSS_BATCH
    toks = torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    seen, kernel = [], ssm_mod.wkv6

    def record(r, k, v, w_log, u, state, *, chunk, **kw):
        seen.append(({"r": r, "k": k, "v": v, "w_log": w_log, "u": u,
                      "state": state}, chunk))
        return kernel(r, k, v, w_log, u, state, chunk=chunk, **kw)
    ssm_mod.wkv6 = record
    try:
        with torch.no_grad():
            api.loss(params, {"tokens": toks, "labels": toks})
    finally:
        ssm_mod.wkv6 = kernel
    (ops, chunk), = seen
    assert all(ops[n].dtype == torch.bfloat16 for n in "rkv")
    LAYER.parent.mkdir(exist_ok=True)
    torch.save({"operands": {n: t.detach().cpu() for n, t in ops.items()},
                "strides": {n: list(t.stride()) for n, t in ops.items()},
                "chunk": chunk}, LAYER)
    print(json.dumps({"captured": str(LAYER.relative_to(ROOT)),
                      "shape": list(ops["r"].shape), "chunk": chunk,
                      "strides": {n: list(t.stride())
                                  for n, t in ops.items()}}), flush=True)
    _ptxas(str(ROOT))


def turn(tree: str) -> None:
    """One tree's rows: the timed shapes, then the hashes."""
    torch, cs, wmod = _imports(tree)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    iters = 10
    for shape, b, s, ch in TIMED:
        args = cs.wkv6_bf16_inputs(torch, gen, b, s, 32, 64)
        f32 = [t.float() for t in args[:3]] + args[3:]
        row = {"tree": tree, "shape": shape, "b": b, "s": s, "chunk": ch}
        for kind, a in (("bf16", args), ("f32", f32)):
            ms = cs.time_ms(lambda i: wmod.wkv6(*a, chunk=ch), 1, iters)
            prof = cs.profile_calls(torch, {kind: lambda: [
                wmod.wkv6(*a, chunk=ch) for _ in range(iters)]},
                repeats=iters)[kind] or []
            passes = {r["kernel"]: r["ms"] / iters for r in prof
                      if r["kernel"].startswith("wkv6_")}
            row[kind] = {"ms": ms, "device_ms": (sum(passes.values())
                                                 if passes else None),
                         "device_ms_by_pass": passes or None}
        print(json.dumps(row), flush=True)
    _ptxas(tree)

    def digest(t):
        t = t.detach().contiguous()
        return hashlib.sha256(
            t.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:20]

    def hashes(case, args, ch):
        b, s, h, p = args[0].shape
        y, S = wmod.wkv6(*args, chunk=ch)
        yk, Sk, ws = wmod._launch(*args, ch, None, torch.bfloat16, keep=True)
        plan = wmod.pass_plan(b, s, h, p, ch)
        parts, at = {}, 0
        for name, shape in (("S_in", plan.states_shape),
                            ("lw", plan.lw_shape), ("dec", plan.dec_shape)):
            n = math.prod(shape)
            parts[name] = digest(ws[at:at + n])
            at += -(-n // 4) * 4
        y32, S32 = wmod.wkv6(*[t.float() for t in args[:3]], *args[3:],
                             chunk=ch)
        torch.cuda.synchronize()
        print(json.dumps({"tree": tree, "case": case, "chunk": ch,
                          "shape": [b, s, h, p],
                          "inputs": [digest(t) for t in args],
                          "y": digest(y), "state": digest(S),
                          "passes": {"y": digest(yk), "state": digest(Sk),
                                     **parts},
                          "f32": {"y": digest(y32), "state": digest(S32)}}),
              flush=True)

    gen.manual_seed(cs.SEED + 21)                 # check_wkv6_bf16's inputs
    for name, b, s, h, p, ch, strided in cs.WKV6_BF16_CASES:
        hashes(f"{name} {(b, s, h, p)} chunk {ch}",
               cs.wkv6_bf16_inputs(torch, gen, b, s, h, p, strided), ch)
    saved = torch.load(LAYER)
    ops = [saved["operands"][n].cuda() for n in
           ("r", "k", "v", "w_log", "u", "state")]
    assert [list(t.stride()) for t in ops[:3]] == [
        saved["strides"][n] for n in "rkv"]
    hashes("rwkv6-1.6b layer 0", ops, saved["chunk"])


def compare(lines) -> dict:
    """Every turn's hashes against the first turn's, case by case."""
    rows = [json.loads(x) for x in lines if x.startswith('{"tree"')]
    cases = [r for r in rows if "case" in r]
    first = {}
    for r in cases:
        first.setdefault(r["case"], r)
    out = {}
    for r in cases:
        ref = first[r["case"]]
        key = {k: r[k] for k in ("inputs", "y", "state", "passes", "f32")}
        want = {k: ref[k] for k in key}
        out.setdefault(r["case"], []).append(key == want)
    return {"bits": {c: all(v) for c, v in out.items()},
            "turns_a_case": sorted({len(v) for v in out.values()}),
            "all_bit_equal": all(all(v) for v in out.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent tree: run every turn")
    ap.add_argument("--tree", help="one turn, this tree's kernels")
    ap.add_argument("--capture", action="store_true",
                    help="capture the rwkv6 layer's operands and stop")
    args = ap.parse_args()
    if args.capture:
        capture()
        return 0
    if args.tree:
        turn(args.tree)
        return 0
    if not args.parent:
        ap.error("--parent or --tree")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    failed, lines = 0, []
    with open(out_dir / "wkv6_bf16_ab.jsonl", "w") as out:
        out.write(json.dumps({"device": smi}) + "\n")
        for argv in (["--capture"], ["--tree", args.parent],
                     ["--tree", str(ROOT)], ["--tree", str(ROOT)],
                     ["--tree", args.parent]):
            done = subprocess.run([sys.executable, __file__, *argv],
                                  capture_output=True, text=True)
            sys.stdout.write(done.stdout)
            sys.stderr.write(done.stderr[-4000:])
            out.write(done.stdout)
            lines += done.stdout.splitlines()
            failed += done.returncode != 0
        summary = compare(lines)
        print(json.dumps(summary), flush=True)
        out.write(json.dumps(summary) + "\n")
    return 1 if failed or not summary["all_bit_equal"] else 0


if __name__ == "__main__":
    sys.exit(main())
