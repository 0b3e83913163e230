"""Training: ``repro_torch.train.trainer.make_train_step`` with the default
``AdamWConfig`` on seeded batches.

Set-up builds one training step with its model and optimizer state (weights
from the seed, ``optim.init_state``) and drives it through its first three
steps with the window's own call and feed (batches 0, 1, 2; every row
differs).  What the check needs of those steps is read then: each step's
loss, each leaf's gradient norm as the optimizer got it at step 1 (its
first moment over ``1 - b1``), and each leaf's change of the f32 master
weights after step 3 (against the weights made again from the seed).  The
window then runs the same object on batches 3, 4, ... until ``seconds``
have passed and waits for the device.

End-to-end candidate: ``train_tokens_per_s``, tokens of the steps issued in
the window over the window's seconds.

Correctness: the plain reference (float32 model, plain AdamW) follows the
three steps from the same weights and batches once the program's state is
freed.  Numbers compared: ``loss_gap`` (the largest ``|loss - reference| /
reference`` of the three), ``grad_gap`` and ``change_gap``: the worst leaf's
``|norm - reference norm|`` over the larger of that leaf's reference norm
and the median leaf's.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of ``change_gap``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List

import torch

from bench.harness import common, traffic as gen, weights
from bench.harness.common import Check, Context, Record
from bench.harness.manifest import load_module
from bench.harness.trace import Slice
from bench.harness.yardstick import Yardstick

FIRST_STEPS = 3
#: a leaf whose reference gradient norm lies under this share of the
#: median leaf's moves by round-off alone
QUIET_LEAF = 1e-3


def batch(ctx: Context, i: int):
    tp = ctx.traffic
    tokens, labels = gen.batch_rows(ctx.seed, i, int(tp["batch"]),
                                    int(tp["seq"]), ctx.cfg.vocab_size,
                                    ctx.device)
    return {"tokens": tokens, "labels": labels}


def _norms(tree_pairs) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in
            tree_pairs}


def program_first_steps(ctx: Context, step, params, opt_state, b1: float):
    """Runs steps 1-3; returns (losses, gradient norms at step 1, change
    norms after step 3) by leaf."""
    losses, grad = [], {}
    for i in range(FIRST_STEPS):
        params, opt_state, loss = step(params, opt_state, batch(ctx, i))
        losses.append(float(loss))
        if i == 0:
            grad = {k: v / (1.0 - b1) for k, v in _norms(
                (k, s["mu"]) for k, s in _state_leaves(opt_state)).items()}
    w0 = weights.make(_specs(ctx), ctx.seed, ctx.device)
    init = dict(weights.leaves(w0))
    change = {k: float(torch.linalg.vector_norm(
        s["master"] - init[k].float())) for k, s in _state_leaves(opt_state)}
    del w0, init
    return losses, grad, change


def _state_leaves(opt_state):
    """(dotted path, state dict of one parameter) in sorted key order."""
    out = []

    def walk(tree, prefix):
        if set(tree) & {"mu", "nu", "master"}:
            out.append((".".join(prefix), tree))
            return
        for k in sorted(tree):
            walk(tree[k], prefix + (k,))
    walk(opt_state["per_param"], ())
    return out


def _specs(ctx: Context):
    from repro_torch.models import model_api
    return model_api(ctx.cfg, device=ctx.device).param_specs()


def run(ctx: Context) -> Record:
    record, first = measure(ctx)
    record.checks = check(ctx, *first)
    return record


def measure(ctx: Context):
    """Set-up (with the first three steps), the window and (with
    ``ctx.trace``) the traced slice; the program's state freed.  Returns
    (record, (losses, gradient norms, change norms) of the first three
    steps)."""
    from repro_torch import optim
    from repro_torch.models import model_api
    from repro_torch.train.trainer import make_train_step
    tp = ctx.traffic
    b, s = int(tp["batch"]), int(tp["seq"])
    dev = ctx.device
    yard = Yardstick(ctx.cfg)
    api = model_api(ctx.cfg, backend=ctx.backend, device=dev)
    opt_cfg = optim.AdamWConfig()
    params = weights.make(api.param_specs(), ctx.seed, dev)
    opt_state = optim.init_state(params, opt_cfg)
    step = make_train_step(api, ctx.cfg, opt_cfg)
    losses3, grad, change = program_first_steps(ctx, step, params, opt_state,
                                                opt_cfg.b1)
    common.sync(dev)
    losses: List[torch.Tensor] = []
    t0 = common.now()
    setup_s = t0 - ctx.t_start
    common.reset_peak(dev)
    while common.now() - t0 < ctx.seconds:
        params, opt_state, loss = step(params, opt_state,
                                       batch(ctx, FIRST_STEPS + len(losses)))
        losses.append(loss)
    common.sync(dev)
    window_s = common.now() - t0
    n = len(losses)
    trace, calls = None, []
    if ctx.trace:
        with Slice() as sl:
            ts = common.now()
            while common.now() - ts < ctx.trace_seconds:
                params, opt_state, _ = step(
                    params, opt_state,
                    batch(ctx, FIRST_STEPS + n + len(calls)))
                calls.append(("train", b, s))
        trace = sl.summary
    peak = common.memory_peak(dev)
    values = [float(x) for x in losses]
    failed = sum(1 for v in values if v != v or abs(v) == float("inf"))
    record = Record(
        kind="train", setup_s=setup_s, window_s=window_s, attempted=n,
        failed=failed, e2e={"train_tokens_per_s": n * b * s / window_s},
        flops_in_window=n * yard.train_flops(b, s), memory_peak_bytes=peak,
        checks=[], trace=trace, calls_in_slice=calls, yard=yard,
        counters={"steps": n})
    del params, opt_state, step, api, losses
    common.free_device()
    return record, (losses3, grad, change)


def reference_steps(ctx: Context, precision: str = "f32",
                    rows: int = 0):
    """The reference's three steps from the seed's weights: (losses,
    clipped gradient norms at step 1, change norms after step 3) by
    leaf.  ``rows`` > 0 keeps only a batch's first rows (a fault: the rest
    of the batch left out)."""
    common.reference_precision()
    common.free_device()
    ref = load_module("reference", ctx.cfg.family)
    adamw = load_module("reference", "adamw")
    h = adamw.Hyper()
    c = dataclasses.asdict(ctx.cfg)
    w0 = weights.make(_specs(ctx), ctx.seed, ctx.device)
    names = [k for k, _ in weights.leaves(w0)]
    p = _tree_map(lambda t: t.float().requires_grad_(True), w0)
    del w0
    leaves = [t for _, t in weights.leaves(p)]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses, grad = [], {}
    for i in range(FIRST_STEPS):
        bt = batch(ctx, i)
        if rows:
            bt = {k: v[:rows] for k, v in bt.items()}
        loss = ref.train_loss(p, c, bt["tokens"], bt["labels"], precision)
        grads = list(torch.autograd.grad(loss, leaves))
        losses.append(float(loss.detach()))
        clip = adamw.clip_factor(h, grads)
        if i == 0:
            grad = {k: float(torch.linalg.vector_norm(g) * clip)
                    for k, g in zip(names, grads)}
        adamw.update(h, i + 1, leaves, grads, mu, nu, clip)
        del grads, loss
    del mu, nu
    w0 = weights.make(_specs(ctx), ctx.seed, ctx.device)
    change = {k: float(torch.linalg.vector_norm(t.detach() - t0.float()))
              for (k, t), (_, t0) in zip(weights.leaves(p),
                                         weights.leaves(w0))}
    return losses, grad, change


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> float:
    """max over leaves of ``|prog - ref| / max(ref, median ref)``."""
    keys = [k for k in ref if keep is None or k in keep]
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def gaps(prog, ref) -> Dict[str, float]:
    """The three numbers compared, from (losses, grad, change) of the
    program and of the reference."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    med = sorted(rg.values())[len(rg) // 2]
    moving = {k for k, v in rg.items() if v >= QUIET_LEAF * med}
    return {"loss_gap": max(abs(a - r) / abs(r) for a, r in zip(pl, rl)),
            "grad_gap": worst_leaf(pg, rg),
            "change_gap": worst_leaf(pc, rc, moving)}


def check(ctx: Context, losses, grad, change, ref=None) -> List[Check]:
    """The numbers that have a limit in the cell's file; the others are
    read and printed, not compared (one that no control or fault
    separates from sound runs could only fail sound runs).  ``ref``, the
    reference's three steps, is worked out where it is not given."""
    ref = reference_steps(ctx) if ref is None else ref
    found = gaps((losses, grad, change), ref)
    for k, v in found.items():
        if k not in ctx.limits:
            print(f"not compared: {k} {v!r}", file=sys.stderr)
    return [Check(k, v, ctx.limits[k]) for k, v in found.items()
            if k in ctx.limits]
