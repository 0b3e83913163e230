"""Scoring: ``ModelAPI.loss`` back to back on seeded batches.

Batch ``i`` of a run is drawn on the device from (seed, i) alone
(:func:`bench.harness.traffic.batch_rows`): ``batch`` rows of ``seq``
tokens, uniform over the vocabulary, each row's labels its next tokens.
Set-up: weights from the seed and ``warmup`` calls (batches -1, -2, ...).
The window issues calls until ``seconds`` have passed and then waits for
the device; the losses stay on the device until the window has closed.

End-to-end candidate: ``score_tokens_per_s``, tokens of the calls issued
in the window over the window's seconds (from the first issue to the
device's end of the last call).

Correctness: ``sample`` of the window's batches (the first, the rest drawn
from the seed).  Once the program's state is freed, the plain reference
computes each one's loss again; the number compared is ``loss_gap``, the
mean of ``|loss - reference| / reference`` over them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from bench.harness import common, traffic as gen, weights
from bench.harness.common import Check, Context, Record
from bench.harness.manifest import load_module
from bench.harness.trace import Slice
from bench.harness.yardstick import Yardstick


def batch(ctx: Context, i: int):
    tp = ctx.traffic
    tokens, labels = gen.batch_rows(ctx.seed, i, int(tp["batch"]),
                                    int(tp["seq"]), ctx.cfg.vocab_size,
                                    ctx.device)
    return {"tokens": tokens, "labels": labels}


def run(ctx: Context) -> Record:
    record, values = measure(ctx)
    record.checks = check(ctx, values)
    return record


def measure(ctx: Context):
    """Set-up, the window and (with ``ctx.trace``) the traced slice; the
    program's state freed.  Returns (record, the window's losses)."""
    from repro_torch.models import model_api
    tp = ctx.traffic
    b, s = int(tp["batch"]), int(tp["seq"])
    dev = ctx.device
    yard = Yardstick(ctx.cfg)
    api = model_api(ctx.cfg, backend=ctx.backend, device=dev)
    params = weights.make(api.param_specs(), ctx.seed, dev)
    for i in range(int(tp.get("warmup", 1))):
        api.loss(params, batch(ctx, -1 - i))
    common.sync(dev)
    losses: List[torch.Tensor] = []
    t0 = common.now()
    setup_s = t0 - ctx.t_start
    common.reset_peak(dev)
    while common.now() - t0 < ctx.seconds:
        losses.append(api.loss(params, batch(ctx, len(losses))))
    common.sync(dev)
    window_s = common.now() - t0
    n = len(losses)
    trace, calls = None, []
    if ctx.trace:
        with Slice() as sl:
            ts = common.now()
            while common.now() - ts < ctx.trace_seconds:
                api.loss(params, batch(ctx, n + len(calls)))
                calls.append(("loss", b, s))
        trace = sl.summary
    peak = common.memory_peak(dev)
    values = [float(x) for x in losses]
    failed = sum(1 for v in values if v != v or abs(v) == float("inf"))
    record = Record(
        kind="score", setup_s=setup_s, window_s=window_s, attempted=n,
        failed=failed,
        e2e={"score_tokens_per_s": n * b * s / window_s},
        flops_in_window=n * yard.forward_flops(b, s),
        memory_peak_bytes=peak, checks=[], trace=trace,
        calls_in_slice=calls, yard=yard,
        counters={"calls": n})
    del params, api, losses
    common.free_device()
    return record, values


def chosen(ctx: Context, n: int) -> List[int]:
    return gen.sample(ctx.seed, n, min(ctx.sample, n), always=0)


def reference_losses(ctx: Context, picks: List[int],
                     precision: str = "f32", rows: int = 0) -> List[float]:
    """The reference's loss of each picked batch; ``rows`` > 0 keeps only
    a batch's first rows (a fault: the rest of the batch left out)."""
    from repro_torch.models import model_api
    common.reference_precision()
    ref = load_module("reference", ctx.cfg.family)
    api = model_api(ctx.cfg, device=ctx.device)
    w = weights.make(api.param_specs(), ctx.seed, ctx.device)
    c = dataclasses.asdict(ctx.cfg)
    out = []
    for i in picks:
        bt = batch(ctx, i)
        if rows:
            bt = {k: v[:rows] for k, v in bt.items()}
        out.append(ref.loss(w, c, bt["tokens"], bt["labels"], precision))
    del w
    common.free_device()
    return out


def loss_gap(values: List[float], refs: List[float]) -> float:
    """The mean over the sampled batches of ``|loss - reference| /
    reference``: a batch's mean over 8192 tokens leaves little of either
    side's rounding, and the mean over the sample keeps the program's
    seeds apart from the control's (a single batch's gap swings by 4x
    from seed to seed)."""
    return sum(abs(v - r) / abs(r) for v, r in zip(values, refs)) / len(refs)


def check(ctx: Context, values: List[float], stand_in=None) -> List[Check]:
    """``loss_gap`` of the sampled window batches.  ``stand_in(picks)``,
    where given, gives the losses judged in place of the program's (the
    control, or a fault planted in the reference)."""
    if not values:
        return [Check("loss_calls", 0.0, -1.0)]
    picks = chosen(ctx, len(values))
    judged = stand_in(picks) if stand_in else [values[i] for i in picks]
    refs = reference_losses(ctx, picks)
    return [Check("loss_gap", loss_gap(judged, refs),
                  ctx.limits["loss_gap"])]
