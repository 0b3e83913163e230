"""Served traffic through ``repro_torch.serve.ServeEngine``.

Clients send requests from the traffic file's stream in a closed loop of
``clients``: each sends its next request when its last one finishes, after
the engine step that finished it returns.  The engine runs ``slots`` decode
slots of ``max_len`` on the configuration's backend.

Set-up: weights from the seed, the engine, and the ramp: the first engine
steps, until every slot has been admitted once.  Then the window: engine
steps until
``seconds`` have passed, each ending in the engine's own synchronisation
(the arg-max read to the host).

End-to-end candidates: ``serve_tokens_per_s`` (tokens emitted in the
window over its seconds) and ``ttft_p95_ms`` (the 95th percentile of submit
to first token over every request whose first token falls in the window).

Correctness: ``sample`` requests finished in the window (the longest among
them, the rest drawn from the seed).  Once the engine's state is freed,
the plain reference runs each prompt with its served tokens once; the
number compared is ``logit_gap``, the widest gap by which a served token's
reference logit lies below the reference's best at its position.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from bench.harness import common, traffic as gen, weights
from bench.harness.common import Check, Context, Record
from bench.harness.trace import Slice
from bench.harness.yardstick import Yardstick


def p95(values: List[float]) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def _span_totals(spans: List[Dict]) -> Dict[str, float]:
    """Count and seconds of the window's decode steps and prefills."""
    out: Dict[str, float] = {}
    for name in ("decode_step", "prefill"):
        durs = [sp["dur_s"] for sp in spans if sp["name"] == name]
        out[f"{name}s"] = len(durs)
        out[f"{name}_s"] = sum(durs)
    return out


class Clients:
    """Submits the stream's requests to the engine and keeps what they
    measured."""

    def __init__(self, engine, stream: gen.RequestStream, tp: Dict,
                 yard: Yardstick) -> None:
        from repro_torch.serve import Request
        self._Request = Request
        self.engine = engine
        self.stream = stream
        self.clients = int(tp["clients"])
        self.yard = yard
        self.finished: List[Any] = []
        self.requests: List[Any] = []
        self.newly: List[Any] = []
        self.window = (math.inf, math.inf)
        self.flops = 0.0
        self.uid = 0

    def _on_token(self, req, tok: int) -> None:
        t = req.first_token_t if len(req.out_tokens) == 1 else \
            self.engine._clock()
        if not (self.window[0] <= t < self.window[1]):
            return
        plen = len(req.prompt)
        j = len(req.out_tokens) - 1
        self.flops += (self.yard.prefill_flops(plen) if j == 0 else
                       self.yard.decode_token_flops(plen + j))

    def _on_finish(self, req) -> None:
        self.newly.append(req)

    def submit_one(self, spec: gen.Spec) -> None:
        req = self._Request(uid=self.uid, prompt=spec.tokens,
                            max_new_tokens=spec.max_new,
                            on_token=self._on_token,
                            on_finish=self._on_finish)
        self.uid += 1
        self.requests.append(req)
        self.engine.submit(req)

    def release(self) -> None:
        """Drop the requests' hooks into this object (and so the engine)."""
        for req in self.requests:
            req.on_token = req.on_finish = None
        self.requests = self.finished = self.newly = []

    def start(self) -> None:
        for _ in range(self.clients):
            self.submit_one(next(self.stream))

    def step(self) -> None:
        """Run one engine step and send each finished client's next
        request."""
        self.engine.step()
        done, self.newly = self.newly, []
        self.finished.extend(done)
        for _ in done:
            self.submit_one(next(self.stream))


def run(ctx: Context) -> Record:
    record, served = measure(ctx)
    record.checks = check(ctx, served)
    return record


def measure(ctx: Context):
    """Set-up, the window and (with ``ctx.trace``) the traced slice; the
    engine's state freed.  Returns (record, the window's finished requests
    as (prompt, served tokens))."""
    from repro_torch.models import model_api
    from repro_torch.serve import ServeEngine
    tp = ctx.traffic
    cfg, dev = ctx.cfg, ctx.device
    clock = common.now
    yard = Yardstick(cfg)
    api = model_api(cfg, device=dev)
    params = weights.make(api.param_specs(), ctx.seed, dev)
    engine = ServeEngine(cfg, params, slots=int(tp["slots"]),
                         max_len=int(tp["max_len"]), backend=ctx.backend,
                         clock=clock, device=dev)
    spans: List[Dict] = []
    engine.obs.tracer.add_sink(
        lambda ev: spans.append(ev) if ev["kind"] == "span" else None)
    stream = gen.RequestStream(ctx.seed, tp, cfg.vocab_size)
    cl = Clients(engine, stream, tp, yard)
    cl.start()
    # the ramp: every slot admitted once
    while engine.stats.admitted < min(cl.clients, engine.slots):
        cl.step()
    common.sync(dev)
    queue = engine.obs.registry.histogram("serve_queue_wait_seconds")
    _, qsum0, qn0 = queue.snapshot()
    tokens0 = engine.stats.tokens_generated
    t0 = clock()
    cl.window = (t0, math.inf)
    setup_s = t0 - ctx.t_start
    common.reset_peak(dev)
    while clock() - t0 < ctx.seconds:
        cl.step()
    t1 = clock()
    cl.window = (t0, t1)
    window_s = t1 - t0
    tokens = engine.stats.tokens_generated - tokens0
    _, qsum1, qn1 = queue.snapshot()
    in_window = [r for r in cl.finished if r.finish_t is not None
                 and t0 <= r.finish_t <= t1]
    firsts = [r for r in cl.finished + list(engine.scheduler.active.values())
              if r.first_token_t is not None and t0 <= r.first_token_t <= t1]
    ttft = [r.first_token_t - r.submit_t for r in firsts]
    failed = sum(1 for r in in_window if r.truncated or r.shed or r.cancelled)
    window_spans = [s for s in spans if t0 <= s["t"] and s["t"] + s["dur_s"]
                    <= t1]
    trace, calls = None, []
    if ctx.trace:
        n0 = len(spans)
        with Slice() as sl:
            ts = clock()
            while clock() - ts < ctx.trace_seconds:
                cl.step()
        trace = sl.summary
        for s in spans[n0:]:
            if s["name"] == "decode_step":
                calls.append(("decode", engine.slots))
            elif s["name"] == "prefill":
                calls.append(("prefill", s["prompt_len"]))
    peak = common.memory_peak(dev)
    record = Record(
        kind="serve", setup_s=setup_s, window_s=window_s,
        attempted=len(in_window), failed=failed,
        e2e={"serve_tokens_per_s": tokens / window_s,
             "ttft_p95_ms": 1e3 * p95(ttft) if ttft else math.nan},
        flops_in_window=cl.flops, memory_peak_bytes=peak, checks=[],
        spans=window_spans,
        counters={"queue_wait_s": qsum1 - qsum0,
                  "queue_waits": qn1 - qn0,
                  "tokens": tokens, "ttft_samples": len(ttft),
                  "requests_finished": len(in_window),
                  **_span_totals(window_spans)},
        trace=trace, calls_in_slice=calls, yard=yard)
    # correctness: the engine's state goes first, the reference after
    served = [(list(r.prompt), list(r.out_tokens)) for r in in_window
              if not r.truncated]
    cl.release()
    del engine, params, cl, stream, api, in_window, firsts
    common.free_device()
    return record, served


def pick(seed: int, served: List, k: int) -> List:
    """``k`` served requests: the longest, and the rest drawn from the
    seed."""
    if not served:
        return []
    longest = max(range(len(served)),
                  key=lambda i: len(served[i][0]) + len(served[i][1]))
    return [served[i] for i in gen.sample(seed, len(served), k, longest)]


def sequences(chosen: List, dev):
    """Each chosen request as the reference reads it: its prompt and served
    tokens but the last, and the positions whose logits chose them."""
    seqs, wanted = [], []
    for prompt, out in chosen:
        seqs.append(torch.tensor(prompt + out[:-1], dtype=torch.long,
                                 device=dev))
        wanted.append(torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out),
                                   device=dev))
    return seqs, wanted


def gaps(judge: List[torch.Tensor], tokens: List[torch.Tensor]) -> List[float]:
    """``best - logit[token]`` at each position, under the logits
    ``judge``."""
    out: List[float] = []
    for lg, tok in zip(judge, tokens):
        out.extend((lg.max(-1).values
                    - lg.gather(1, tok[:, None].long())[:, 0]).tolist())
    return out


def reference_inputs(ctx: Context):
    """The reference's weights (made again from the seed) and plain
    configuration."""
    import dataclasses
    from repro_torch.models import model_api
    api = model_api(ctx.cfg, device=ctx.device)
    w = weights.make(api.param_specs(), ctx.seed, ctx.device)
    return w, dataclasses.asdict(ctx.cfg)


def check(ctx: Context, served: List, precision: str = "") -> List[Check]:
    """``logit_gap`` of the sampled requests' served tokens.  With
    ``precision`` (``"int8"``, ``"fp8"``: the control) the tokens judged
    are, at each position of the same requests, the ones that the
    reference in that precision puts first, in place of the program's."""
    from bench.harness.manifest import load_module
    common.reference_precision()
    chosen = pick(ctx.seed, served, ctx.sample)
    if not chosen:
        return [Check("served_requests", 0.0, -1.0)]
    ref = load_module("reference", ctx.cfg.family)
    w, c = reference_inputs(ctx)
    seqs, wanted = sequences(chosen, ctx.device)
    with torch.no_grad():
        f32 = ref.logits_at(w, c, seqs, wanted)
        if precision:
            tokens = [lg.argmax(-1) for lg in
                      ref.logits_at(w, c, seqs, wanted, precision)]
        else:
            tokens = [torch.tensor(out, device=ctx.device)
                      for _, out in chosen]
    return [Check("logit_gap", max(gaps(f32, tokens)),
                  ctx.limits["logit_gap"])]
