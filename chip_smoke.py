#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc``, holds each against its
plain PyTorch version at the shapes the models give it, runs the paper flow on
one full-width weight, runs the precision-island loop
(``repro_torch.examples.precision_islands``: Razor flags -> Algorithm-2 tier
calibration -> tiered product, on the ``razor_matmul`` and
``precision_island`` kernels) at phi4-mini-3.8b's four weight shapes, and
serves a few requests on phi4-mini-3.8b at its published width and depth
through ``repro_torch.launch.serve`` -> ``ServeEngine`` -> ``ModelAPI`` ->
``backend.matmul`` -> the ``systolic_mac`` kernel; then the same traffic on the
paper's emulated voltage-island array (``--backend emulated --hwloop``: the
``hwloop`` tiled form, held first against its plain tile loop), the
Algorithm-2 watchdog healing an undervolted rail on the serving device, and a
short run on the simulated array; then guarded (``--guard abft`` on
``reference`` and on the emulated array, each GEMM's checks one
``abft_checksums`` launch and each verification one ``abft_verdict`` launch,
beside unguarded runs of the same workload; the chaos campaign's
``silent_burst`` and ``watchdog_delay`` scripts) and autoscaled (``--autoscale threshold``
from a ladder the flow CLI writes on the card) phi4-mini serving; phi4-mini
behind the HTTP frontend (``repro_torch.server``: streams bit-equal to the
direct run's, and the ``--serve-http`` launcher as a child process serving
the same six streams to clients in this process), a
traffic trace replayed through ``--trace`` (every metric but the wall clock
equal to the CPU's replay), and the chaos campaign's four wire scenarios
(``repro_torch.resilience.chaos``) on the guarded emulated array; then the
dispatch census (``repro_torch.analysis.census``): the six smoke configs'
routed GEMMs, matrix products and kernel calls equal to the CPU's pins
(``census_baseline_torch.json``), and the full-width phi4 prefill, decode step
and ``ServeEngine`` step with their host synchronisations by site; then the
port's examples through their ``run()`` (``repro_torch.examples``):
quickstart beside a direct ``flow.run``, serve_batched, hwloop_serve
(emulated and probe) and traffic_overload (``reference``: every model GEMM
one ``systolic_mac`` launch) on the same phi4-mini weights, and train_lm at
its full ~100M-parameter, 300-step size.  Then, for
rwkv6-1.6b and
zamba2-2.7b at their published width and depth: the same traffic served
(every rwkv6 layer of every step on the ``wkv6`` kernel), the parallel forward
against token-by-token decoding, and ``ModelAPI.loss`` on a (2, 2048) batch
(``wkv6`` / ``ssd_chunk`` in every layer); for rwkv6 also the bf16 recurrence
(``cfg.ssm_bf16=True``): the bf16 ``wkv6`` against its plain bf16 version at
the loss, decode, ragged, one-chunk and strided shapes, timed beside the f32
kernel, then a (1, 512) ``loss`` and the launcher's traffic on ``reference``
with every recurrence on it, and a served request's decode logits against
the plain bf16 route.  Then the other families at their
published width, the same traffic through the launcher on ``systolic_mac``:
seamless-m4t-medium (encoder-decoder; also with seeded frames on its
requests), llama4-scout-17b-a16e (MoE, 8 of its 48 layers) and
llava-next-mistral-7b (VLM), each beside ``--slots 1`` and ``ideal``; and
their frontends: llava's prefill of 2880 patch embeddings, seamless's and
llama4's ``ModelAPI.loss``.  Last, training: phi4-mini-3.8b at published
width and depth through ``repro_torch.train.train`` (4 steps of 2 x 256
tokens under ``reference``, every forward GEMM on ``systolic_mac`` with
straight-through gradients, then the same steps under ``ideal``, then 2
steps with int8 moments), the JAX package's trainer tests at their smoke
sizes (descent, resume), whether a repeated step gives the same bits, one
step of the rwkv6 and zamba2 smoke configs, each also with
``ssm_bf16=True``; then rwkv6-1.6b and zamba2-2.7b at published width and
depth through the same trainer (4 steps of 2 x 256 tokens under
``reference`` and ``ideal``), and rwkv6-1.6b again with ``ssm_bf16=True``:
the recurrences' backward kernels (``wkv6_bwd``, its bf16 variant
``wkv6_bwd_bf16`` and ``ssd_chunk_bwd``, held first against their plain
versions, their device ms a call at the train and loss shapes to
``BWD_LIMIT_MS`` and their launches a call to ``BWD_LAUNCH_LIMIT``) on the
main path.  B1's device ms over llava's prefill and a phi4-mini train step
are held to ``B1_LIMIT_MS``.  Then the device mesh: a one-rank ``nccl`` group
and a (1, 1) mesh (``repro_torch.launch.mesh``); through ``build_cell``'s
rules, beside the same work with ``rules=None``: one phi4-mini train step at
full width and four decode steps of the served model; one train step each of
rwkv6-1.6b, zamba2-2.7b and rwkv6-1.6b with ``ssm_bf16=True`` (the
recurrences' forward and backward kernels through ``local_map``) and four
decode steps of rwkv6 and zamba2; seamless-m4t-medium's prefill with seeded
frames, decode steps and a train step; llava-next-mistral-7b's 2880-patch
prefill and decode steps, and llama4-scout's (8 layers) decode steps.  Each
is bit-equal to the unsharded run, with every kernel's launches as counted
(``systolic_mac`` once a GEMM).  Last the dry run
(``repro_torch.launch.dryrun``) of phi4-mini-3.8b x train_4k on a ``fake``
group of 256 ranks in a child process.  Weights are random, from seeded
generators.
Needs a GPU and ``nvcc``; any phase that fails ends the run with
a non-zero exit code.

Output: one JSON object per line — ``env``, ``build``, ``kernel_checks``
(``systolic_mac`` at every model's GEMM shapes, phi4-mini's, rwkv6's and
zamba2's also at a train step's 512 rows; its wide form (bf16 from
``WIDE_FROM_M`` rows) bit-equal to 16-row calls of the same rows at every
bf16 weight of llava's prefill and the three train steps, M = 512, 2944 and
ragged, both layouts of b; ``razor_matmul``,
``precision_island``, ``wkv6``, ``ssd_chunk``, and the backward kernels
``wkv6_bwd``, ``wkv6_bwd_bf16`` and ``ssd_chunk_bwd``), ``paper_flow``,
``precision_islands``, ``hwloop_checks``, ``abft_checks``, ``serve`` (with a
``torch.profiler`` pass over a short run), ``serve_hwloop``, ``serve_guard``,
``autoscale``, ``serve_http``, ``serve_trace``, ``chaos``, per state-space
model
``serve_ssm``, ``decode_vs_parallel`` and ``loss`` (with a profile by CUDA
kernel), per model of the other families ``serve_families`` and
``frontends``, ``census`` (the census phase's counts, sync sites and
seconds), ``examples`` (each example's checked results and seconds),
``wkv6_bf16`` (its checks, the bf16 model run and seconds),
``train`` (per backend: losses, seconds a step, tokens/s, the
optimizer's seconds on the stream (CUDA events; the timed steps add no host
synchronisation to the trainer's), step 0's gradient norm, peak memory, B1 launches and
device ms a step; the smoke trainer's checks), ``train_ssm`` (the same per
state-space model, rwkv6 also with ``ssm_bf16``, and backend, with the
recurrences' forward and backward launches a step and their device ms in a
profiled step), ``mesh_note``,
``mesh``
(the one-rank mesh's train, prefill and decode steps of every family
beside the unsharded ones: bits, launches, seconds, device ms by kernel of
a profiled step; the dry run's record and trace seconds), ``profile_misses`` (profiled
measurements left null, with what each try saw), ``total`` (the script's
seconds),
then ``{"kernels": [...]}`` (per
kernel: launches on its path, error against the plain version, time, the
plain version's and one library call's time, and the least time the card
could take), the card's name and power limit as ``nvidia-smi`` gives them,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12,      # tensor cores, f32 accumulate
              "tf32": 495e12,          # tensor cores, f32 accumulate
              "float32": 67e12,        # outside the tensor cores
              "float64": 34e12}        # outside the tensor cores
#: products a 3xTF32 split takes for one f32 product (ssd_chunk, wkv6)
TF32_SPLIT_PASSES = 3
PEAK_INT8_OPS = 1979e12                # tensor cores

ARCH = "phi4-mini-3.8b"
DEVICE = "cuda"
SLOTS, MAX_LEN, REQUESTS, MAX_NEW, SEED = 4, 64, 6, 8, 0
DECODE_M = SLOTS
#: tolerances of the kernel against its plain version, as fractions of
#: max|C|: clean cells differ by summation order only; a corrupted cell can
#: fall on the other side of one truncation step (2^-8 of its value)
TOL_CLEAN = 1e-5
TOL_CORRUPT = 2.5 * 2.0 ** -8


def tol_corrupt(keep_bits: int) -> float:
    """``TOL_CORRUPT`` for another number of kept mantissa bits."""
    return max(TOL_CLEAN, 2.5 * 2.0 ** -keep_bits)
#: prefill logits under `reference` against `ideal`, as a fraction of
#: max|logits|: both accumulate in f32 and round to bf16 after every GEMM,
#: from sums taken in another order, so single bf16 roundings (2^-8) flip and
#: travel through 32 layers
TOL_LOGITS = 0.05
#: razor_matmul / precision_island against their plain versions: integer
#: cells bit for bit; shadow and f32 cells differ by summation order only
#: (TOL_CLEAN of max|C|); rel by the shadow's rounding (relative 1e-4);
#: flags are compared outside a band of 1e-4 * tol around tol
TOL_REL = 1e-4
TOL_BAND = 1e-4
#: M of the precision-island checks: a 256-token prefill chunk
CHUNK_M = 256
ISLAND_BLOCK, ISLAND_TOL = 128, 0.02
#: the state-space models, served, scored and held decode against parallel
SSM_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
#: wkv6 / ssd_chunk against their plain versions, y and the final state as
#: fractions of their largest magnitudes: f32 sums in another order (the
#: plain version's products run on cuBLAS in f32); the kernels' products on
#: TF32 tensor cores with a 3xTF32 split, which drops about 2^-21 of each
#: term (a single TF32 pass, 2^-11, would not hold this)
TOL_RECURRENCE = 1e-4
#: the backward kernels' reduced gradients against their plain versions, as
#: fractions of their largest magnitudes: du, dA_log and dD are sums over
#: the batch and every row, dw_log a reverse cumsum over a chunk's rows of
#: terms that cancel (d/dlw of the clamped exponentials, up to e^60 times
#: e^-60): one f32 sum of up to 2 x 2048 x 64 terms in another order than
#: the plain version's, each term with the products' 3xTF32 error
TOL_REDUCED_GRAD = 1e-3
#: one Mamba2 layer's token-by-token steps against its parallel forward, as
#: a fraction of the largest output (tests/models/test_consistency.py);
#: the whole model's last logits are held to TOL_LOGITS of max|logits|
#: instead: the two forms round to bf16 at other places in every one of
#: zamba2's 63 residual blocks (54 Mamba2, 9 shared), and the gap grows with
#: depth (one layer 0.2-0.4 %, the whole model 3-4 %, chip_smoke's own
#: decode_vs_parallel rows)
TOL_DECODE_PARALLEL = 2e-2
#: wkv6's clamp on the centred exponents (the Pallas kernel's EXP_CLAMP)
WKV6_CLAMP = 60.0
#: seeded noise, as a fraction of max|y|, added to every wkv6 output of the
#: plain route's parallel forward: where a difference this far below one
#: TF32 split's rounding moves rwkv6's last logits by TOL_LOGITS or more,
#: decode_vs_parallel does not hold the kernels' logits to the plain route's
WKV6_NOISE_PROBE = 1e-7
#: the loss on the kernels against the loss with the recurrences on their
#: plain versions, relative: a last-bit difference in y can flip a later
#: bf16 rounding, which moves a mean over 4096 positions by far less
TOL_LOSS = 1e-3
#: (batch, sequence) of the scored batch
LOSS_BATCH = (2, 2048)
#: (M, K, N) of the hwloop checks, whose plain tile loop stays short: a
#: decode step's rows over a full-width K, ragged K and N, many column tiles
HWLOOP_SHAPES = ((4, 3072, 64), (7, 200, 20), (16, 64, 1024))
#: the tiled form against the loop: float64 products summed in another
#: order, as a fraction of max|C|; rel_error relative
TOL_TILED = 1e-12
TOL_TILED_REL = 1e-9
#: abft_checksums against its plain version, as a fraction of the sums of
#: magnitudes: float64 sums of the same terms taken in another order
TOL_ABFT = 1e-12
#: the guard's residual tolerance (GuardedBackend's default, --guard abft)
GUARD_TOL = 1e-6
#: what the guard may cost a served reference step, against unguarded runs
#: of the same workload in the same call: model step and host ms a GEMM as
#: ratios, profiled kernel launches a step (copies not counted: the guard's
#: one read a verification is a copy) as an excess
GUARD_LIMITS = {"model_step_ratio": 2.0, "host_ms_per_gemm_ratio": 4.0,
                "launches_per_model_step_over_unguarded": 500}
#: device ms the guard's kernels may take over a guarded decode step's 225
#: calls, as the profiler reads them in served decode steps (serve_guard)
ABFT_STEP_LIMIT_MS = {"abft_checksums": 6.0, "abft_verdict": 1.5}
#: device ms one backward call of the recurrences may take (torch.profiler,
#: the state gradient zero) at the train (2 x 256) and loss (2 x 2048)
#: shapes, and the kernels one call may launch: the redesign's limits
BWD_LIMIT_MS = {("ssd_chunk_bwd", "train"): 0.22, ("ssd_chunk_bwd", "loss"): 1.2,
                ("wkv6_bwd", "train"): 0.14, ("wkv6_bwd", "loss"): 0.9,
                ("wkv6_bwd_bf16", "train"): 0.14,
                ("wkv6_bwd_bf16", "loss"): 0.9}
BWD_LAUNCH_LIMIT = 4
#: device ms B1 may take over llava's 2944-row prefill (its 225 GEMMs, in
#: the profiled prefill) and over a phi4-mini train step's 417 GEMMs at
#: M = 512 (in the profiled step, and timed one shape at a time): the wide
#: form's limits; a figure not measured fails
B1_LIMIT_MS = {"llava_prefill": 250.0, "phi4_train_step": 40.0}
#: decode steps the second of serve_guard's two profiled guarded runs adds
#: (the same prefills): the difference is the served decode steps' own
PROFILE_DECODE_EXTRA = 4
#: new tokens a request in the autoscale phase: 23 decode steps, room for
#: three descents under the launcher's dwell of 8 steps
AUTOSCALE_NEW = 24
#: bounded admission queue of the HTTP and trace phases (--max-pending)
HTTP_MAX_PENDING = 8
#: the trace: 1.5x the deployment's token capacity for 10 s, each model call
#: costing 65 ms of virtual time (about the served phi4 step)
TRACE_OVERLOAD, TRACE_STEP_COST, TRACE_DURATION = 1.5, 0.065, 10.0
#: the chaos campaign's wire scenarios (the engine-level pair runs in
#: serve_guard)
CHAOS_SCENARIOS = ["rail_droop", "slow_decode", "client_disconnect",
                   "overload_shed"]
#: the other families, served at published width through the launcher:
#: encdec, moe (depth cut to FAMILY_LAYERS) and vlm
FAMILY_ARCHS = ("seamless-m4t-medium", "llama4-scout-17b-a16e",
                "llava-next-mistral-7b")
#: llama4-scout on one card: 8 of its 48 layers (about 4.4 GB of bf16 a
#: layer, almost all of it the 16 experts; the whole model about 211 GB)
FAMILY_LAYERS = {"llama4-scout-17b-a16e": 8}
#: grok-1-314b is not served (about 9.7 GB a layer); its f32 router's
#: N = 8 is checked among the kernel's shapes
GROK = "grok-1-314b"
#: (batch, sequence) of the frontends phase's scored batches
FRONTEND_LOSS = (1, 256)
#: llava's prefill in the frontends phase: its anyres patch positions
#: (cfg.frontend_tokens) in front of a prompt of this many tokens, then
#: this many decode steps
VLM_PROMPT, VLM_STEPS = 64, 8
#: the train phase, phi4-mini at published width and depth: SyntheticDataset
#: batches of (batch, sequence), steps under reference and then under ideal
#: from the same seeded state, steps with int8 moments
TRAIN_BATCH, TRAIN_STEPS, TRAIN_INT8_STEPS = (2, 256), 4, 2
#: B1's rows in a train step's GEMMs: every position of the batch
TRAIN_M = TRAIN_BATCH[0] * TRAIN_BATCH[1]
#: rows of the wide form's bit checks: a train step's, llava's prefill and
#: ragged counts (a partial last row tile)
WIDE_MS = (TRAIN_M, 2944, 129, 1000, 2945)
#: step 0's loss under reference against ideal, relative (as TOL_LOSS)
TOL_TRAIN_LOSS = 1e-3
#: step 0's global gradient norm under reference against ideal, relative:
#: the two gradients g and g + e agree leaf by leaf within |e| <= 1.8e-2 |g|
#: (the worst leaf of tests/test_torch_train.py's step-0 comparisons, both
#: backends), and | |g + e| - |g| | <= |e|
TOL_GNORM = 2e-2
#: the JAX package's trainer tests at their own smoke sizes (batch 4 x 32):
#: descent over 16 steps, and 4 steps + resume for 2 = 6 straight steps
SMOKE_TRAIN_SHAPE = (32, 4)
#: the mesh phase: decode steps of each served model on a one-rank mesh,
#: and the dry run's cell (traced on a fake process group of 256 ranks)
MESH_DECODE_STEPS = 4
#: seamless's prompt tokens on the mesh (beside MAX_LEN // 4 seeded frames)
MESH_PROMPT = 8
DRYRUN_CELL = ("phi4-mini-3.8b", "train_4k")
#: the census phase: the pins of the CPU's dispatch census, and the prompt of
#: the full-width phi4 prefill it counts
CENSUS_BASELINE = "census_baseline_torch.json"
CENSUS_PROMPT = 16
#: the examples phase: train_lm at the size its docstring calls the full
#: run (d_model, layers, steps; batch and sequence its defaults), where its
#: checkpoints go, and the seconds the phase is meant to take
EXAMPLES_TRAIN_LM = dict(d_model=768, layers=12, steps=300, batch=4,
                         seq=128)
EXAMPLES_CHECKPOINT_DIR = ROOT / "build" / "chip_smoke" / "train_lm"
EXAMPLES_BUDGET_S = 150.0
#: the bf16 wkv6 against its plain bf16 version, y as a fraction of max|y|:
#: one bf16 step (2^-7 of a value's leading power of two) of the largest
#: output; the kernel's f32 sums behind a score or the intra-chunk output
#: run in another order than cuBLAS's, so now and then one of them rounds to
#: the neighbouring bf16 value (the state stays f32: TOL_RECURRENCE)
TOL_WKV6_BF16 = 2.0 ** -7
#: where a chunk holds more than one row, the bf16 wkv6's y must lie at
#: least this many times closer to its plain bf16 version than the f32
#: route's y on the same operands does, by relative Frobenius norm (the CPU
#: tests' rule against the reference): the kernel differs from the plain
#: version in a few elements by one bf16 step, the f32 route almost
#: everywhere, so the max-norm limit alone would pass an f32 kernel
WKV6_BF16_SEPARATION = 4.0
#: rwkv6 with ssm_bf16=True on the kernel against the plain bf16 route:
#: decode logits within the CPU tests' BF16_TOL of max|logits|
TOL_BF16_LOGITS = 4 * 2.0 ** -8
#: (batch, sequence) of the bf16 rwkv6 loss on reference, and the served
#: bf16 run's requests and new tokens
WKV6_BF16_LOSS = (1, 512)
WKV6_BF16_REQUESTS, WKV6_BF16_NEW = 4, 4
#: the bf16 wkv6's cases (name, b, s, h, p, chunk, strided): rwkv6-1.6b's
#: loss shape and decode shapes, ragged chunks, one chunk, a strided p 47
WKV6_BF16_CASES = (("rwkv6 loss", 2, 2048, 32, 64, 64, False),
                   ("rwkv6 decode", 4, 1, 32, 64, 1, False),
                   ("rwkv6 decode", 1, 1, 32, 64, 1, False),
                   ("ragged", 1, 100, 32, 64, 100, False),
                   ("ragged", 1, 1000, 32, 64, 1000, False),
                   ("one chunk", 1, 64, 32, 64, 64, False),
                   ("strided", 2, 256, 12, 47, 128, True),
                   ("strided", 2, 3, 12, 47, 1, True))
#: device ms one bf16 wkv6 call may take at rwkv6's loss shape (its three
#: passes, torch.profiler), the bf16 tiles' redesign's limit; it must also
#: take less than the f32 kernel on the same values in the same call; a
#: figure not measured fails
WKV6_BF16_LIMIT_MS = 0.22


def emit(tag: str, payload: dict) -> None:
    print(json.dumps({tag: payload}), flush=True)


def fail(msg: str) -> "NoReturn":
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n_variants: int, iters: int) -> float:
    """Mean milliseconds of ``fn(i)`` over ``iters`` launches after a
    warm-up, by CUDA events.  ``i`` cycles over ``n_variants`` operand copies
    that together exceed the L2 cache, so every launch finds its weight cold,
    as a decode step does."""
    import torch
    for i in range(min(2, iters)):
        fn(i % n_variants)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_variants)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_rows(fn, n_variants: int, iters: int):
    """Device milliseconds per call of ``fn(i)`` by CUDA kernel (and
    memset), by ``torch.profiler``: ``iters`` calls cycling ``n_variants``
    operand copies as :func:`time_ms` does, each kernel's summed time over
    ``iters``.  Unlike back-to-back events it leaves out the host's launch
    work.  None where the profiler does not see every call's kernels (not
    measured)."""
    import torch
    rows = profile_calls(torch, {"calls": lambda: [
        fn(i % n_variants) for i in range(iters)]}, repeats=iters)["calls"]
    if rows is None:
        return None
    return [dict(r, ms=r["ms"] / iters, calls=r["calls"] / iters)
            for r in rows]


def device_ms(fn, n_variants: int, iters: int):
    """The summed device milliseconds per call of :func:`device_rows`."""
    rows = device_rows(fn, n_variants, iters)
    return None if rows is None else sum(r["ms"] for r in rows)


def host_us_per_call(torch, fn, calls: int, reps: int) -> float:
    """Host microseconds per call, median of ``reps`` runs of ``calls``
    calls each, timed from a synchronised start to the last enqueue (no
    synchronisation inside)."""
    for _ in range(min(50, calls)):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return sorted(runs)[len(runs) // 2]


def host_us_beside(torch, fn, library, calls: int, reps: int) -> dict:
    """Host microseconds per call of ``fn`` and of ``library`` (one library
    launch: the host's speed at that moment), timed in alternating runs of
    ``calls`` calls as :func:`host_us_per_call` times them; medians of
    ``reps`` runs each, and the median of the runs' ratios, which a slower
    or faster host moves less than either time."""
    for f in (fn, library):
        for _ in range(min(50, calls)):
            f()
    torch.cuda.synchronize()
    runs, lib_runs = [], []
    for _ in range(reps):
        for f, out in ((fn, runs), (library, lib_runs)):
            t0 = time.perf_counter()
            for _ in range(calls):
                f()
            out.append(1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
    ratios = sorted(r / q for r, q in zip(runs, lib_runs))

    def median(x):
        return sorted(x)[len(x) // 2]
    return {"host_us_per_call": median(runs),
            "library_host_us_per_call": median(lib_runs),
            "host_us_ratio_to_library": ratios[len(ratios) // 2]}


def bound_ms(m: int, k: int, n: int, gm: int, gn: int, dtype_name: str):
    """Least time the card could take for one systolic_mac call: every input
    (a, b, v_map, v_safe) read once, every output (C f32, flags, count)
    written once, against the operations at the peak rate of the inputs'
    type."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * (m * k + k * n) + 4 * m * n + 3 * 4 * gm * gn + 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[dtype_name]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by


def check_epilogue(torch, c, flags, block_m, block_n, keep_bits, what):
    """The bit-cast-and-mask epilogue, exactly: every element of a flagged
    cell has its low ``23 - keep_bits`` mantissa bits at zero, and every
    clean cell holds at least one element with such a bit set (an f32 sum of
    random products that was never masked).  A tolerance cannot see this: the
    mask moves a value by less than ``2^-keep_bits`` of itself."""
    low = (1 << (23 - keep_bits)) - 1
    if low == 0:
        return                                  # nothing to mask off
    gm, gn = flags.shape
    low_bits = (c.view(torch.int32) & low).reshape(gm, block_m, gn, block_n)
    any_low = (low_bits != 0).any(dim=3).any(dim=1)         # (gm, gn)
    fired = flags.bool()
    if bool((any_low & fired).any()):
        fail(f"{what}: a flagged cell keeps low mantissa bits "
             f"(keep_bits={keep_bits})")
    if bool((~any_low & ~fired).any()):
        fail(f"{what}: a clean cell has its low mantissa bits masked "
             f"(keep_bits={keep_bits})")


def check_counted(torch, systolic_mac, args, kw, c, flags, what):
    """The reference backend's launch, ``counter=``: on the same operands
    and rails as the fresh-count call that gave ``c`` and ``flags``, it adds
    exactly ``flags.sum()`` into a count that does not start at zero, and
    its result and flags equal that call's bit for bit."""
    start = 1000
    counter = torch.full((), start, dtype=torch.int32, device=c.device)
    c2, flags2 = systolic_mac(*args, **kw, counter=counter)
    if not (torch.equal(c2.view(torch.int32), c.view(torch.int32))
            and torch.equal(flags2, flags)):
        fail(f"{what}: counter= gives another result or flag map than "
             f"count_flags=True")
    if int(counter) != start + int(flags.sum()):
        fail(f"{what}: counter= added {int(counter) - start}, flags.sum() "
             f"is {int(flags.sum())}")


def dense_gemms(cfg):
    """name -> (K, N, launches per model step, transposed view?, dtype) of
    every GEMM of a dense model's decode step (phi4-mini)."""
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    L, bf = cfg.n_layers, "bfloat16"
    return {"wq/wo": (d, qd, 2 * L, False, bf),
            "wk/wv": (d, kvd, 2 * L, False, bf),
            "w1/wg": (d, ff, 2 * L, False, bf),
            "w2": (ff, d, L, False, bf),
            "logits": (d, cfg.padded_vocab, 1, True, bf)}


def rwkv6_gemms(cfg):
    """The same for rwkv6: r, k, v, g, o and the channel mix's receptance
    are d x d; the decay LoRA's second factor is multiplied in f32."""
    d, ff, L, bf = cfg.d_model, cfg.d_ff, cfg.n_layers, "bfloat16"
    lora = max(32, d // 64)
    return {"wr/wk/wv/wg/wo/cr": (d, d, 6 * L, False, bf),
            "w_lora_a": (d, lora, L, False, bf),
            "w_lora_b (f32)": (lora, d, L, False, "float32"),
            "ck": (d, ff, L, False, bf),
            "cv": (ff, d, L, False, bf),
            "logits": (d, cfg.padded_vocab, 1, True, bf)}


def zamba2_gemms(cfg):
    """The same for zamba2: in/out projections of 54 Mamba2 layers, the
    shared block's down projection, attention and MLP at each of its nine
    applications."""
    d, ff, L, bf = cfg.d_model, cfg.d_ff, cfg.n_layers, "bfloat16"
    d_inner = 2 * d
    n_heads = d_inner // cfg.ssm_d_head
    in_dim = 2 * d_inner + 2 * cfg.ssm_state + n_heads
    apps = L // cfg.shared_attn_period
    return {"in_proj": (d, in_dim, L, False, bf),
            "out_proj/down": (d_inner, d, L + apps, False, bf),
            "wq/wk/wv/wo": (d, cfg.q_dim, 4 * apps, False, bf),
            "w1/wg": (d, ff, 2 * apps, False, bf),
            "w2": (ff, d, apps, False, bf),
            "logits": (d, cfg.padded_vocab, 1, True, bf)}


def encdec_gemms(cfg):
    """The same for seamless-m4t-medium's decode step: each decoder layer's
    self-attention (q, k, v, o), cross-attention q and o (the memory's K/V
    are projected once, at prefill) and MLP."""
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    L, bf = cfg.n_layers, "bfloat16"
    return {"wq/wo (self, cross)": (d, qd, 4 * L, False, bf),
            "wk/wv": (d, kvd, 2 * L, False, bf),
            "w1/wg": (d, ff, 2 * L, False, bf),
            "w2": (ff, d, L, False, bf),
            "logits": (d, cfg.padded_vocab, 1, True, bf)}


def moe_gemms(cfg):
    """The same for an MoE model's decode step (llama4-scout): attention, the
    f32 router (N = the experts), and the up/gate/down products of every
    expert (dense dispatch: each expert multiplies every token) and of the
    shared expert."""
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    L, bf = cfg.n_layers, "bfloat16"
    ffns = cfg.n_experts + int(cfg.shared_expert)
    return {"wq/wo": (d, qd, 2 * L, False, bf),
            "wk/wv": (d, kvd, 2 * L, False, bf),
            "router (f32)": (d, cfg.n_experts, L, False, "float32"),
            "w1/wg (experts, shared)": (d, ff, 2 * ffns * L, False, bf),
            "w2 (experts, shared)": (ff, d, ffns * L, False, bf),
            "logits": (d, cfg.padded_vocab, 1, True, bf)}


def family_gemms(cfg):
    """(prefill, decode step) GEMMs of a model of the other families, as
    ``models/lm.py`` and ``models/encdec.py`` launch them (swiglu MLPs):
    seamless's prefill runs the encoder (7 a layer) and, a decoder layer,
    attention (whose K/V fill the cache), the memory's K/V, cross-attention
    q/o and the MLP (11); its decode step 9 a layer."""
    L = cfg.n_layers
    if cfg.family == "encdec":
        return 7 * cfg.n_enc_layers + 11 * L + 1, 9 * L + 1
    per_layer = 7
    if cfg.n_experts:
        per_layer = 5 + 3 * (cfg.n_experts + int(cfg.shared_expert))
    return per_layer * L + 1, per_layer * L + 1


def check_serving_shapes(torch, arch, weights, systolic_mac,
                         systolic_mac_plain, largest_common_block,
                         ms=range(1, 8),
                         timed_ms=(1, DECODE_M, 7)):
    """Every (K, N) a model multiplies by (``weights``, from
    :func:`dense_gemms` and its siblings), nominal rails, on the flag grid
    the reference backend uses: checked at every M in ``ms`` (a prompt's
    length in prefill, the slots in decode), timed at ``timed_ms``.  The
    timed call is the reference backend's launch (``counter=``, a running
    count), back to back by events (``kernel_ms``) and on
    the device by the profiler (``device_ms``); ``torch.matmul`` of the same
    operands beside it (``library_ms``, ``library_device_ms``)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = []
    for name, (k, n, per_step, transposed, dname) in weights.items():
        dtype = getattr(torch, dname)
        elem = torch.finfo(dtype).bits // 8
        # enough copies to exceed the 50 MB L2 between reuses
        copies = max(1, math.ceil(120e6 / (elem * k * n)))
        if transposed:      # the tied unembedding: (V, d) storage, .T view
            store = torch.randn((copies, n, k), generator=gen, device=dev,
                                dtype=torch.float32).mul_(0.02).to(dtype)
            bs = [store[i].T for i in range(copies)]
        else:
            store = torch.randn((copies, k, n), generator=gen, device=dev,
                                dtype=torch.float32).mul_(
                                    1 / math.sqrt(k)).to(dtype)
            bs = [store[i] for i in range(copies)]
        for m in ms:
            a = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            block = largest_common_block(m, n)
            gm, gn = m // block, n // block
            v_map = torch.ones((gm, gn), device=dev)
            v_safe = torch.zeros((gm, gn), device=dev)

            c, flags, count = systolic_mac(a, bs[0], v_map, v_safe,
                                           block_m=block, block_n=block,
                                           count_flags=True)
            torch.cuda.synchronize()
            c_ref, flags_ref = systolic_mac_plain(
                a, bs[0], v_map, v_safe, block_m=block, block_n=block)
            scale = float(c_ref.abs().max())
            err = float((c - c_ref).abs().max())
            flags_equal = bool(torch.equal(flags, flags_ref))
            if not (math.isfinite(err) and err <= TOL_CLEAN * scale):
                fail(f"systolic_mac {arch} {name} M={m}: max err {err} over "
                     f"limit {TOL_CLEAN * scale}")
            if not flags_equal or int(count) != 0 or int(flags.sum()) != 0:
                fail(f"systolic_mac {arch} {name} M={m}: flags differ or "
                     f"fired at nominal rails")

            entry = {
                "arch": arch, "weight": name, "M": m, "K": k, "N": n,
                "dtype": dname, "b_transposed_view": transposed,
                "flag_cell": block, "max_err": err,
                "max_err_limit": TOL_CLEAN * scale,
                "flags_equal": flags_equal}
            out.append(entry)
            if m not in timed_ms:
                continue
            iters = 4 if transposed else 24
            counter = torch.zeros((), dtype=torch.int32, device=dev)

            def kernel(i):
                return systolic_mac(a, bs[i], v_map, v_safe, block_m=block,
                                    block_n=block, counter=counter)

            def library(i):
                return torch.matmul(a, bs[i])

            t_kernel = time_ms(kernel, copies, iters)
            t_plain = time_ms(
                lambda i: systolic_mac_plain(a, bs[i], v_map, v_safe,
                                             block_m=block, block_n=block),
                copies, iters)
            t_lib = time_ms(library, copies, iters)
            t_bound, by = bound_ms(m, k, n, gm, gn, dname)
            entry.update({
                "launches_per_model_step": per_step, "kernel_ms": t_kernel,
                "device_ms": device_ms(kernel, copies, iters),
                "plain_ms": t_plain, "library_ms": t_lib,
                "library_device_ms": device_ms(library, copies, iters),
                "bound_ms": t_bound, "bound_by": by})
            if int(counter) != 0:
                fail(f"systolic_mac {arch} {name} M={m}: cells fired at "
                     f"nominal rails")
        del store, bs
    return out


#: check_faulting's (M, K, N, cell rows, cell columns): the flow's shape,
#: and a train step's rows on phi4-mini's wk/wv (bf16: the wide form)
FAULT_CASES = ((256, 384, 512, 64, 128), (TRAIN_M, 3072, 1024, 32, 64))


def check_faulting(torch, systolic_mac, systolic_mac_plain):
    """Rails drawn around the safe voltage, in f32 and bf16, at 0, 8 and 23
    kept mantissa bits, at each of FAULT_CASES: flags, the fused count, both
    tolerances, and the epilogue bit for bit.  The kernel sums an element in
    one fixed order, so its result at these rails must equal its own result
    at nominal rails with exactly the flagged cells masked."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    out = []
    for (m, k, n, bm, bn), dtype in (
            (case, dtype) for case in FAULT_CASES
            for dtype in (torch.float32, torch.bfloat16)):
        gm, gn = m // bm, n // bn
        name = str(dtype).replace("torch.", "")
        a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
        v_safe = torch.full((gm, gn), 0.85, device=dev)
        v_map = 0.85 + 0.1 * (torch.rand((gm, gn), generator=gen,
                                         device=dev) - 0.5)
        c_nominal, flags_nominal = systolic_mac(
            a, b, torch.ones_like(v_map), v_safe, block_m=bm, block_n=bn)
        if int(flags_nominal.sum()) != 0:
            fail(f"systolic_mac faulting {name}: flags at nominal rails")
        for keep_bits in (0, 8, 23):
            what = f"systolic_mac faulting {name} keep_bits={keep_bits}"
            c, flags, count = systolic_mac(a, b, v_map, v_safe, block_m=bm,
                                           block_n=bn, keep_bits=keep_bits,
                                           count_flags=True)
            torch.cuda.synchronize()
            c_ref, flags_ref = systolic_mac_plain(
                a, b, v_map, v_safe, block_m=bm, block_n=bn,
                keep_bits=keep_bits)
            if not torch.equal(flags, flags_ref):
                fail(f"{what}: flag maps differ")
            fired = int(flags.sum())
            if int(count) != fired or not 0 < fired < gm * gn:
                fail(f"{what}: fused count {int(count)} vs flags.sum() "
                     f"{fired} of {gm * gn} cells")
            bad = flags_ref.bool().repeat_interleave(
                bm, 0).repeat_interleave(bn, 1)
            # exactly: flagged cells are the nominal result with the low
            # bits cleared, clean cells are the nominal result
            keep = -(1 << (23 - keep_bits))         # 0xFFFFFFFF << (23 - kb)
            want_bits = torch.where(bad, c_nominal.view(torch.int32) & keep,
                                    c_nominal.view(torch.int32))
            if not torch.equal(c.view(torch.int32), want_bits):
                fail(f"{what}: result is not the nominal result with the "
                     f"flagged cells' low {23 - keep_bits} bits cleared")
            check_epilogue(torch, c, flags, bm, bn, keep_bits, what)
            check_counted(torch, systolic_mac, (a, b, v_map, v_safe),
                          {"block_m": bm, "block_n": bn,
                           "keep_bits": keep_bits}, c, flags, what)
            scale = float(c_ref.abs().max())
            diff = (c - c_ref).abs()
            err_clean = float(diff[~bad].max())
            err_bad = float(diff[bad].max())
            lim_bad = tol_corrupt(keep_bits) * scale
            if not err_clean <= TOL_CLEAN * scale:
                fail(f"{what}: clean cells off by {err_clean} (limit "
                     f"{TOL_CLEAN * scale})")
            if not err_bad <= lim_bad:
                fail(f"{what}: corrupted cells off by {err_bad} (limit "
                     f"{lim_bad})")
            entry = {
                "weight": "faulting", "M": m, "K": k, "N": n, "dtype": name,
                "flag_cell": [bm, bn], "keep_bits": keep_bits,
                "fired": fired, "flags_equal": True,
                "count_equals_flag_sum": True, "masked_bit_for_bit": True,
                "counter_adds_flag_sum": True,
                "max_err_clean": err_clean,
                "max_err_clean_limit": TOL_CLEAN * scale,
                "max_err_corrupt": err_bad, "max_err_corrupt_limit": lim_bad}
            out.append(entry)
            if keep_bits != 8:
                continue
            t_kernel = time_ms(
                lambda i: systolic_mac(a, b, v_map, v_safe, block_m=bm,
                                       block_n=bn, count_flags=True), 1, 24)
            t_plain = time_ms(
                lambda i: systolic_mac_plain(a, b, v_map, v_safe, block_m=bm,
                                             block_n=bn), 1, 24)
            t_lib = time_ms(lambda i: torch.matmul(a, b), 1, 24)
            t_bound, by = bound_ms(m, k, n, gm, gn, name)
            entry.update({"kernel_ms": t_kernel, "plain_ms": t_plain,
                          "library_ms": t_lib, "bound_ms": t_bound,
                          "bound_by": by})
    return out


def model_weight(torch, gen, k, n, dtype, transposed):
    """A (K, N) weight as a model holds it: row-major, or the tied
    unembedding's transposed view of a (N, K) table."""
    dev = gen.device
    if transposed:
        return torch.randn((n, k), generator=gen, device=dev).mul_(
            0.02).to(dtype).T
    return torch.randn((k, n), generator=gen, device=dev).mul_(
        1 / math.sqrt(k)).to(dtype)


def check_row_invariance(torch, systolic_mac, shapes):
    """Contract 1 of the kernel, at nominal rails: for every (K, N) in
    ``shapes`` (every model's weights) and both types, row 0 of the calls at
    M = 1..8 is bit-equal to the M = 1 call (phi4-mini's w2 also at M = 64
    and 256), and a second identical call at M = 4 is bit-equal to the
    first (contract 2; every one of these shapes but the logits splits K)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    v, vs = torch.ones((1, 1), device=dev), torch.zeros((1, 1), device=dev)
    out = []
    for (k, n, transposed), wide in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            b = model_weight(torch, gen, k, n, dtype, transposed)
            a = torch.randn((256, k), generator=gen, device=dev).to(dtype)
            ref = systolic_mac(a[:1], b, v, vs)[0][0].view(torch.int32)
            ms = list(range(1, 9)) + ([64, 256] if wide else [])
            for m in ms:
                c = systolic_mac(a[:m], b, v, vs)[0]
                if not torch.equal(c[0].view(torch.int32), ref):
                    fail(f"systolic_mac row invariance ({k}, {n}) {name}: row "
                         f"0 at M={m} differs from M=1")
            c4 = systolic_mac(a[:4], b, v, vs)[0]
            again = systolic_mac(a[:4], b, v, vs)[0]
            if not torch.equal(c4.view(torch.int32), again.view(torch.int32)):
                fail(f"systolic_mac ({k}, {n}) {name} M=4: a second identical "
                     f"call differs")
            out.append({"K": k, "N": n, "b_transposed_view": transposed,
                        "dtype": name, "M": ms,
                        "row0_bit_equal_to_M1": True,
                        "repeat_bit_equal": True})
            del a, b
    torch.cuda.synchronize()
    return out


#: rows of the 16-row form's block (kernels/systolic_mac.py::TILE_M)
TILE_ROWS = 16


def check_wide_rows(torch, systolic_mac, launch_rows, shapes):
    """The wide form against the 16-row form, bit for bit: for every bf16
    (K, N, transposed view?) in ``shapes`` (llava's prefill weights and the
    phi4-mini / rwkv6 / zamba2 train steps'), at each M of WIDE_MS, the one
    call (the wide form) equals, ``view(torch.int32)`` so -0.0 and NaN
    payloads included, the same rows computed 16 at a time (the 16-row
    form) from the same operands, and a second identical call equals the
    first.  Rows 1-3 of a hold adversarial values: exponents spread over
    2^-60..2^60, bf16 subnormals, and a row whose products cancel."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 22)
    v, vs = torch.ones((1, 1), device=dev), torch.zeros((1, 1), device=dev)
    out = []
    for k, n, transposed in shapes:
        b = model_weight(torch, gen, k, n, torch.bfloat16, transposed)
        a = torch.randn((max(WIDE_MS), k), generator=gen, device=dev)
        a[1] *= torch.exp2(torch.randint(-60, 61, (k,), generator=gen,
                                         device=dev).float())
        a[2] *= 1e-39
        a[3] = a[0]
        a[3, k // 2:] = -a[0, :k - k // 2]
        a = a.to(torch.bfloat16)
        for m in WIDE_MS:
            what = (f"systolic_mac wide form ({m}, {k}) x ({k}, {n})"
                    f"{' transposed view' if transposed else ''}")
            if launch_rows(a[:m], b) == TILE_ROWS:
                fail(f"{what}: the call does not take the wide form")
            if launch_rows(a[:TILE_ROWS], b) != TILE_ROWS:
                fail(f"{what}: 16 rows do not take the 16-row form")
            c = systolic_mac(a[:m], b, v, vs)[0]
            again = systolic_mac(a[:m], b, v, vs)[0]
            if not torch.equal(c.view(torch.int32), again.view(torch.int32)):
                fail(f"{what}: a second identical call differs")
            del again
            rows = torch.cat([systolic_mac(a[i:min(i + TILE_ROWS, m)], b, v,
                                           vs)[0]
                              for i in range(0, m, TILE_ROWS)])
            differ = int((c.view(torch.int32)
                          != rows.view(torch.int32)).sum())
            if differ:
                fail(f"{what}: {differ} elements differ from the 16-row "
                     f"calls' bits")
            out.append({"M": m, "K": k, "N": n, "b_transposed_view":
                        transposed, "row16_calls": -(-m // TILE_ROWS),
                        "bit_equal_to_row16_calls": True,
                        "repeat_bit_equal": True})
            del c, rows
        del a, b
    torch.cuda.synchronize()
    return out


def check_ragged(torch, systolic_mac, systolic_mac_plain, launch_rows):
    """The shapes the bulk copies cannot take, in both types and both
    layouts of b: M in {1, 3, 9, 17}, K in {1, 15, 1000}, N in {1, 7, 1001};
    offset views (a[:, 1:], b[1:, 1:]: base pointers and row strides not
    16-byte aligned) at (1000, 1001) and at the aligned shape (1024, 1024);
    and partial row tiles of the wide form, M in {129, 1000} at (K, N) =
    (72, 1024) and (1000, 1001) (bf16 where the tensor maps take b: the
    wide form; ``wide_form`` says which ran).
    Rails drawn around the safe voltage on 1 x 7 (or 1 x 1) cells: flags
    equal, the count equal to flags.sum(), both tolerances, and the result
    equal to the kernel's own nominal result with the flagged cells' low
    bits cleared."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    keep = -(1 << (23 - 8))
    out = []
    cases = [(m, k, n, False) for m in (1, 3, 9, 17) for k in (1, 15, 1000)
             for n in (1, 7, 1001)]
    cases += [(m, k, n, True) for m in (1, 3, 9, 17)
              for k, n in ((1000, 1001), (1024, 1024))]
    cases += [(m, k, n, False) for m in (129, 1000)
              for k, n in ((72, 1024), (1000, 1001))]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for transposed in (False, True):
            for m, k, n, offset in cases:
                o = 1 if offset else 0
                a = torch.randn((m, k + o), generator=gen,
                                device=dev).to(dtype)[:, o:]
                if transposed:
                    b = torch.randn((n + o, k + o), generator=gen,
                                    device=dev).to(dtype)[o:, o:].T
                else:
                    b = torch.randn((k + o, n + o), generator=gen,
                                    device=dev).to(dtype)[o:, o:]
                bm, bn = 1, (7 if n % 7 == 0 else 1)
                gm, gn = m // bm, n // bn
                v_safe = torch.full((gm, gn), 0.85, device=dev)
                v_map = 0.85 + 0.1 * (torch.rand((gm, gn), generator=gen,
                                                 device=dev) - 0.5)
                what = (f"systolic_mac ragged {name} (M, K, N) = {(m, k, n)} "
                        f"b {'transposed' if transposed else 'row-major'}"
                        f"{' offset views' if offset else ''}")
                c, flags, count = systolic_mac(a, b, v_map, v_safe,
                                               block_m=bm, block_n=bn,
                                               count_flags=True)
                c_nom, _ = systolic_mac(a, b, torch.ones_like(v_map), v_safe,
                                        block_m=bm, block_n=bn)
                torch.cuda.synchronize()
                c_ref, flags_ref = systolic_mac_plain(
                    a, b, v_map, v_safe, block_m=bm, block_n=bn)
                if not torch.equal(flags, flags_ref):
                    fail(f"{what}: flag maps differ")
                fired = int(flags.sum())
                if int(count) != fired:
                    fail(f"{what}: count {int(count)} vs flags.sum() {fired}")
                bad = flags_ref.bool().repeat_interleave(
                    bm, 0).repeat_interleave(bn, 1)
                want = torch.where(bad, c_nom.view(torch.int32) & keep,
                                   c_nom.view(torch.int32))
                if not torch.equal(c.view(torch.int32), want):
                    fail(f"{what}: not the nominal result with the flagged "
                         f"cells masked")
                check_counted(torch, systolic_mac, (a, b, v_map, v_safe),
                              {"block_m": bm, "block_n": bn}, c, flags, what)
                scale = float(c_ref.abs().max())
                diff = (c - c_ref).abs()
                err_clean = float(diff[~bad].max()) if bool((~bad).any()) \
                    else 0.0
                err_bad = float(diff[bad].max()) if bool(bad.any()) else 0.0
                if not (math.isfinite(err_clean)
                        and err_clean <= TOL_CLEAN * scale):
                    fail(f"{what}: clean cells off by {err_clean} (limit "
                         f"{TOL_CLEAN * scale})")
                if not err_bad <= tol_corrupt(8) * scale:
                    fail(f"{what}: corrupted cells off by {err_bad} (limit "
                         f"{tol_corrupt(8) * scale})")
                out.append({
                    "M": m, "K": k, "N": n, "dtype": name,
                    "b_transposed_view": transposed, "offset_views": offset,
                    "wide_form": launch_rows(a, b) != TILE_ROWS,
                    "flag_cell": [bm, bn], "fired": fired,
                    "flags_equal": True, "count_equals_flag_sum": True,
                    "counter_adds_flag_sum": True,
                    "masked_bit_for_bit": True,
                    "max_err_clean": err_clean,
                    "max_err_clean_limit": TOL_CLEAN * scale,
                    "max_err_corrupt": err_bad,
                    "max_err_corrupt_limit": tol_corrupt(8) * scale})
    return out


#: host-cost shape: one of rwkv6-1.6b's d x d GEMMs at decode, bf16 (its
#: device work, some 5 us, is well under any of the three calls' host work)
HOST_COST_SHAPE = (DECODE_M, 2048, 2048)


def host_cost(torch, systolic_mac, backend_mod, largest_common_block,
              calls=2000, reps=5):
    """Host microseconds per call, median of ``reps`` runs of ``calls``
    calls each, timed from a synchronised start to the last enqueue (no
    synchronisation inside): ``systolic_mac(..., count_flags=True)`` called
    directly; the routed model GEMM, ``backend.matmul`` under
    ``use_backend("reference")``; and ``torch.matmul`` at the same shape."""
    m, k, n = HOST_COST_SHAPE
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 22)
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    block = largest_common_block(m, n)
    v_map = torch.ones((m // block, n // block), device=dev)
    v_safe = torch.zeros_like(v_map)

    def per_call_us(fn):
        return host_us_per_call(torch, fn, calls, reps)

    out = {"M": m, "K": k, "N": n, "dtype": "bfloat16", "calls": calls,
           "reps": reps}
    out["systolic_mac_us"] = per_call_us(lambda: systolic_mac(
        a, b, v_map, v_safe, block_m=block, block_n=block, count_flags=True))
    with backend_mod.use_backend("reference") as be:
        out["reference_route_us"] = per_call_us(
            lambda: backend_mod.matmul(a, b))
        be.pop_telemetry()
    out["torch_matmul_us"] = per_call_us(lambda: torch.matmul(a, b))
    return out


def paper_flow(torch, cfg, ops, systolic_mac_plain):
    """``voltage_scaled_matmul`` on one full-width MLP weight: the kernel
    against the same op run on the plain version."""
    import numpy as np
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    m, k, n, block = 256, cfg.d_model, cfg.d_ff, 128
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device=dev)
         / math.sqrt(k)).to(torch.bfloat16)

    def plain_mac(a, b, v_map, v_safe, *, block_m, block_n, count_flags):
        c, flags = systolic_mac_plain(a, b, v_map, v_safe, block_m=block_m,
                                      block_n=block_n)
        return c, flags, flags.sum()

    t0 = time.monotonic()
    c, info = ops.voltage_scaled_matmul(a, b, block=block, n_partitions=4)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    c_ref, info_ref = ops.voltage_scaled_matmul(a, b, block=block,
                                                n_partitions=4, mac=plain_mac)
    for key in ("v_static", "v_runtime", "flags_static", "flags_runtime"):
        if not np.array_equal(info[key], info_ref[key]):
            fail(f"paper_flow: {key} differs between kernel and plain")
    for key in ("n_fired_static", "n_fired_runtime"):
        if info[key] != info_ref[key]:
            fail(f"paper_flow: {key} {info[key]} vs {info_ref[key]}")
    if info["n_fired_static"] != int(info["flags_static"].sum()):
        fail("paper_flow: fused count differs from the flag map's sum")
    # the product returned is the second (runtime-rails) launch's: clean
    # cells to the tight limit, flagged cells to the loose one, and the
    # mask itself exactly
    fired = torch.as_tensor(info_ref["flags_runtime"], device=dev)
    check_epilogue(torch, c, fired, block, block, 8, "paper_flow")
    bad = fired.bool().repeat_interleave(block, 0).repeat_interleave(block, 1)
    scale = float(c_ref.abs().max())
    diff = (c - c_ref).abs()
    err_clean, err = float(diff[~bad].max()), float(diff[bad].max())
    if not err_clean <= TOL_CLEAN * scale:
        fail(f"paper_flow: clean cells off by {err_clean} (limit "
             f"{TOL_CLEAN * scale})")
    if not err <= TOL_CORRUPT * scale:
        fail(f"paper_flow: flagged cells off by {err} (limit "
             f"{TOL_CORRUPT * scale})")
    ratio = info["energy_ratio_vs_nominal"]
    if not ratio < 1.0:
        fail(f"paper_flow: energy ratio {ratio} is not below nominal")
    return {"M": m, "K": k, "N": n, "dtype": "bfloat16", "block": block,
            "n_partitions": 4, "n_fired_static": info["n_fired_static"],
            "n_fired_runtime": info["n_fired_runtime"],
            "cells": int(info["flags_static"].size),
            "max_err_clean": err_clean,
            "max_err_clean_limit": TOL_CLEAN * scale,
            "max_err_corrupt": err, "max_err_corrupt_limit": TOL_CORRUPT * scale,
            "energy_ratio_vs_nominal": ratio, "seconds": seconds}


def weight_shapes(cfg):
    """(name, K, N) of the model's per-layer weights."""
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return [("wq/wo", d, qd), ("wk/wv", d, kvd), ("w1/wg", d, ff),
            ("w2", ff, d)]


def cold_copies(b):
    """``b`` and enough clones of it to exceed the 50 MB L2 between reuses,
    for :func:`time_ms` to cycle over."""
    copies = max(1, math.ceil(120e6 / (b.element_size() * b.numel())))
    return [b] + [b.clone() for _ in range(copies - 1)]


def integer_gemm_bound_ms(m, k, n, elem, ops_s, cell_bytes):
    """Least time for one razor_matmul or precision_island call: what the
    function needs, a and b (``elem`` bytes an element) read once, C (f32)
    written once and ``cell_bytes`` of per-cell inputs and outputs (tier
    map, flags, rel, count); the kernels' own int8 copies are their
    design's, not the function's, and are not counted.  Against ``ops_s``
    seconds of arithmetic at the peak rates."""
    nbytes = elem * (m * k + k * n) + 4 * m * n + cell_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S
    by = "bytes" if t_bytes >= ops_s else "operations"
    return 1e3 * max(t_bytes, ops_s), by


def check_quant(torch, ref, quant_rows, x, what):
    """quant_rows against the oracle quantizers, bit for bit, at both
    levels; the padding columns are zero."""
    k = x.shape[1]
    for levels, oracle in ((127, ref.quantize_sym_i8),
                           (7, ref.quantize_sym_i4)):
        q, scale = quant_rows(x, levels)
        q_ref, s_ref = oracle(x)
        if not (torch.equal(q[:, :k], q_ref) and bool((q[:, k:] == 0).all())
                and torch.equal(scale, s_ref[:, 0])):
            fail(f"quant_rows {what} levels={levels}: differs from the "
                 f"oracle")


def check_quant_ties(torch, ref, quant_rows):
    """Rows whose ``x / scale`` lands exactly on k + 1/2: row 0 has scale 1
    at levels 7, row 1 at levels 127.  Rounding must go to even; random
    operands hardly ever meet a tie.  Both layouts of x, both types, K not a
    multiple of the k tile."""
    halves = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5, 6.5, -6.5]
    x = torch.tensor([[7.0] + halves, [127.0] + halves[:-1] + [100.5]],
                     device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        xt = x.to(dtype)
        check_quant(torch, ref, quant_rows, xt, f"ties {dtype}")
        check_quant(torch, ref, quant_rows, xt.T.contiguous().T,
                    f"ties {dtype}, column-major")


def cells_mask(torch, cell_map, bm, bn):
    return cell_map.repeat_interleave(bm, 0).repeat_interleave(bn, 1)


def compare_cells(torch, c, c_ref, exact_cells, what):
    """Cells on an integer path bit for bit, the others within TOL_CLEAN of
    max|C|.  Returns (max error on the float cells, its limit)."""
    ci, ri = c.view(torch.int32), c_ref.view(torch.int32)
    if not torch.equal(ci[exact_cells], ri[exact_cells]):
        n_bad = int((ci[exact_cells] != ri[exact_cells]).sum())
        fail(f"{what}: {n_bad} integer-path elements differ from the plain "
             f"version")
    scale = float(c_ref.abs().max())
    lim = TOL_CLEAN * scale
    rest = ~exact_cells
    err = float((c - c_ref).abs()[rest].max()) if bool(rest.any()) else 0.0
    if not (math.isfinite(err) and err <= lim):
        fail(f"{what}: float cells off by {err} (limit {lim})")
    return err, lim


def razor_case(torch, razor_matmul, razor_matmul_plain, a, b, tol, what,
               select_blocks):
    """One razor_matmul call against its plain version: flags outside the
    band, rel, count, and the cells."""
    m, n = a.shape[0], b.shape[1]
    bm, bn = select_blocks(m, n)
    c, flags, rel, count = razor_matmul(a, b, tol=tol, count_flags=True)
    again = razor_matmul(a, b, tol=tol, count_flags=True)
    torch.cuda.synchronize()
    if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip((c, flags, rel, count), again)):
        fail(f"{what}: a repeated call differs in C, flags, rel or count")
    c_ref, f_ref, rel_ref = razor_matmul_plain(a, b, tol=tol, block_m=bm,
                                               block_n=bn)
    band = (rel_ref - tol).abs() <= TOL_BAND * tol
    in_band = int(band.sum())
    if not torch.equal(flags[~band], f_ref[~band]):
        fail(f"{what}: flag maps differ outside the band around tol")
    if int(count) != int(flags.sum()):
        fail(f"{what}: fused count {int(count)} vs flags.sum() "
             f"{int(flags.sum())}")
    rel_err = float(((rel - rel_ref).abs() / rel_ref.abs().clamp_min(1e-30))
                    .max())
    if not rel_err <= TOL_REL:
        fail(f"{what}: rel off by {rel_err} relative (limit {TOL_REL})")
    # the cells where both flags agree are compared; a band cell (none
    # expected) is left out
    agree = flags == f_ref
    main_cells = cells_mask(torch, agree & (flags == 0), bm, bn)
    shadow_cells = cells_mask(torch, agree & (flags == 1), bm, bn)
    err, lim = compare_cells(torch, torch.where(shadow_cells | main_cells, c,
                                                c_ref), c_ref, main_cells,
                             what)
    return {"M": m, "K": a.shape[1], "N": n,
            "dtype": str(a.dtype).replace("torch.", ""), "tol": tol,
            "flag_cell": [bm, bn], "cells": int(flags.numel()),
            "fired": int(flags.sum()), "cells_in_band": in_band,
            "count_equals_flag_sum": True, "main_cells_bit_equal": True,
            "repeat_bit_equal": True,
            "max_err_shadow": err, "max_err_limit": lim,
            "rel_max_rel_err": rel_err, "rel_limit": TOL_REL}


def random_weight(torch, gen, k, n, dtype, transposed=False):
    """A (K, N) weight of N(0, 1/K) entries; ``transposed`` gives it as the
    ``.T`` view of an (N, K) tensor, as the tied unembedding is used."""
    if transposed:
        return (torch.randn((n, k), generator=gen, device=gen.device)
                / math.sqrt(k)).to(dtype).T
    return (torch.randn((k, n), generator=gen, device=gen.device)
            / math.sqrt(k)).to(dtype)


def split_tol(torch, rel):
    """A tol in the widest gap between neighbouring rel values in the middle
    half of the cells: both kinds of cell, and none near the edge."""
    r = torch.sort(rel.flatten().double()).values.cpu()
    lo, hi = len(r) // 4, max(len(r) * 3 // 4, len(r) // 4 + 1)
    gaps = r[lo + 1:hi + 1] - r[lo:hi]
    i = lo + int(torch.argmax(gaps))
    return float((r[i] + r[i + 1]) / 2)


def check_razor(torch, cfg, kernels, ref, select_blocks):
    """razor_matmul at M = 256 against each full-width weight and at the JAX
    tests' shapes, bf16 and f32; the outlier case; times."""
    razor_matmul, razor_matmul_plain, quant_rows = kernels
    check_quant_ties(torch, ref, quant_rows)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    cases = [(name, CHUNK_M, k, n) for name, k, n in weight_shapes(cfg)]
    cases += [("jax-test", 256, 256, 256), ("jax-test", 128, 384, 256),
              ("ragged", 96, 100, 80), ("ragged, b a transposed view", 96,
                                        100, 80)]
    out = []
    for name, m, k, n in cases:
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = random_weight(torch, gen, k, n, dtype,
                              transposed=name.endswith("view"))
            dname = str(dtype).replace("torch.", "")
            check_quant(torch, ref, quant_rows, a, f"{name} a {dname}")
            check_quant(torch, ref, quant_rows, b.T, f"{name} b.T {dname}")
            bm, bn = select_blocks(m, n)
            _, _, rel0 = razor_matmul_plain(a, b, tol=1.0, block_m=bm,
                                            block_n=bn)
            tol = split_tol(torch, rel0) if rel0.numel() > 1 else 0.05
            what = f"razor_matmul {name} {m}x{k}x{n} {dname}"
            entry = razor_case(torch, razor_matmul, razor_matmul_plain, a, b,
                               tol, what, select_blocks)
            entry["weight"] = name
            if not 0 < entry["fired"] < entry["cells"] and entry["cells"] > 1:
                fail(f"{what}: {entry['fired']} of {entry['cells']} cells "
                     f"fired at tol {tol}: both kinds are needed")
            out.append(entry)
            if name not in {w for w, _, _ in weight_shapes(cfg)}:
                continue
            iters = 10 if dtype == torch.bfloat16 else 4
            bs = cold_copies(b)
            t_kernel = time_ms(lambda i: razor_matmul(a, bs[i], tol=tol),
                               len(bs), iters)
            t_plain = time_ms(lambda i: razor_matmul_plain(
                a, bs[i], tol=tol, block_m=bm, block_n=bn), len(bs), iters)
            t_lib = time_ms(lambda i: torch.matmul(a, bs[i]), len(bs), iters)
            by_kernel = device_rows(lambda i: razor_matmul(a, bs[i], tol=tol),
                                    len(bs), iters)
            entry["device_ms"] = (None if by_kernel is None
                                  else sum(r["ms"] for r in by_kernel))
            entry["device_ms_by_kernel"] = by_kernel
            entry["library_device_ms"] = device_ms(
                lambda i: torch.matmul(a, bs[i]), len(bs), iters)
            if name == "w1/wg" and dtype == torch.bfloat16:
                # eight launches a call: few enough calls that the launch
                # queue never fills and holds the host back
                entry.update(host_us_beside(
                    torch, lambda: razor_matmul(a, b, tol=tol,
                                                count_flags=True),
                    lambda: torch.matmul(a, b), calls=20, reps=7))
            del bs
            ops_s = (2.0 * m * n * k / PEAK_INT8_OPS
                     + 2.0 * m * n * k / PEAK_FLOPS[dname])
            gcells = (m // bm) * (n // bn)
            # flags and rel (4 bytes a cell each) and the count
            t_bound, by = integer_gemm_bound_ms(
                m, k, n, 2 if dtype == torch.bfloat16 else 4, ops_s,
                2 * 4 * gcells + 4)
            entry.update({"kernel_ms": t_kernel, "plain_ms": t_plain,
                          "library_ms": t_lib,
                          "library": "torch.matmul (the shadow product alone)",
                          "bound_ms": t_bound, "bound_by": by})

    # the outlier case of the JAX tests: one huge weight element wrecks its
    # column's int8 scale; only that cell fires and is corrected to the
    # shadow product
    a = torch.randn((128, 256), generator=gen, device=dev)
    b = torch.randn((256, 256), generator=gen, device=dev)
    b[0, 0] = 1000.0
    _, _, rel0 = razor_matmul_plain(a, b, tol=1.0, block_m=128, block_n=128)
    r0, r1 = float(rel0[0, 0]), float(rel0[0, 1])
    if not r0 > r1 * 1.2:
        fail(f"razor_matmul outlier: poisoned cell rel {r0} not above the "
             f"clean cell's {r1}")
    tol = 0.5 * (r0 + r1)
    entry = razor_case(torch, razor_matmul, razor_matmul_plain, a, b, tol,
                       "razor_matmul outlier", select_blocks)
    c, flags, _ = razor_matmul(a, b, tol=tol)
    if flags.tolist() != [[1, 0]]:
        fail(f"razor_matmul outlier: flags {flags.tolist()}, want [[1, 0]]")
    shadow = a @ b
    err = float((c[:, :128] - shadow[:, :128]).abs().max())
    lim = TOL_CLEAN * float(shadow.abs().max())
    if not err <= lim:
        fail(f"razor_matmul outlier: fired cell is {err} from the shadow "
             f"product (limit {lim})")
    entry.update({"weight": "outlier b[0,0]=1000", "fired_cell_vs_shadow":
                  err, "fired_cell_vs_shadow_limit": lim})
    out.append(entry)
    return out


def island_tiers(torch, gm, gn, dev):
    """A map with every tier, cell (i, j) at (i + j) % 3."""
    i = torch.arange(gm, device=dev)[:, None]
    j = torch.arange(gn, device=dev)[None, :]
    return ((i + j) % 3).to(torch.int32)


def precision_case(torch, precision_island, precision_island_plain, a, b,
                   tiers, what):
    """One precision_island call against its plain version (integer cells
    bit for bit, f32 cells within TOL_CLEAN of max|C|), and a repeated call
    against the first, bit for bit."""
    m, n = a.shape[0], b.shape[1]
    gm, gn = tiers.shape
    bm, bn = m // gm, n // gn
    c = precision_island(a, b, tiers)
    again = precision_island(a, b, tiers)
    torch.cuda.synchronize()
    if not torch.equal(c.view(torch.int32), again.view(torch.int32)):
        fail(f"{what}: a repeated call gives other bits")
    c_ref = precision_island_plain(a, b, tiers, block_m=bm, block_n=bn)
    exact = cells_mask(torch, (tiers == 0) | (tiers == 1), bm, bn)
    err, lim = compare_cells(torch, c, c_ref, exact, what)
    return {"M": m, "K": a.shape[1], "N": n,
            "dtype": str(a.dtype).replace("torch.", ""),
            "flag_cell": [bm, bn],
            "cells_per_tier": [int((tiers == t).sum()) for t in range(3)],
            "integer_cells_bit_equal": True, "repeat_bit_equal": True,
            "max_err_f32": err, "max_err_limit": lim}


def check_precision_island(torch, cfg, kernels):
    """precision_island at M = 256 against each full-width weight with every
    tier present, maps that lack a level, and the JAX tests' shapes and
    maps, bf16 and f32; times (back to back, device time by kernel, host us
    a call at w1/wg)."""
    precision_island, precision_island_plain = kernels
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    out = []
    for name, k, n in weight_shapes(cfg):
        m = CHUNK_M
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = (torch.randn((k, n), generator=gen, device=dev)
                 / math.sqrt(k)).to(dtype)
            gm, gn = m // ISLAND_BLOCK, n // ISLAND_BLOCK
            tiers = island_tiers(torch, gm, gn, dev)
            entry = precision_case(torch, precision_island,
                                   precision_island_plain, a, b, tiers,
                                   f"precision_island {name} {dname}")
            entry["weight"] = name
            out.append(entry)
            iters = 10 if dtype == torch.bfloat16 else 4
            bs = cold_copies(b)
            t_kernel = time_ms(lambda i: precision_island(a, bs[i], tiers),
                               len(bs), iters)
            t_plain = time_ms(lambda i: precision_island_plain(
                a, bs[i], tiers, block_m=ISLAND_BLOCK, block_n=ISLAND_BLOCK),
                len(bs), iters)
            t_lib = time_ms(lambda i: torch.matmul(a, bs[i]), len(bs), iters)
            by_kernel = device_rows(lambda i: precision_island(a, bs[i],
                                                               tiers),
                                    len(bs), iters)
            entry["device_ms"] = (None if by_kernel is None
                                  else sum(r["ms"] for r in by_kernel))
            entry["device_ms_by_kernel"] = by_kernel
            entry["library_device_ms"] = device_ms(
                lambda i: torch.matmul(a, bs[i]), len(bs), iters)
            if name == "w1/wg" and dtype == torch.bfloat16:
                # six launches a call, as razor_matmul's eight: few enough
                # calls that the launch queue never fills
                entry.update(host_us_beside(
                    torch, lambda: precision_island(a, b, tiers),
                    lambda: torch.matmul(a, b), calls=20, reps=7))
            del bs
            per_cell = 2.0 * ISLAND_BLOCK * ISLAND_BLOCK * k
            n_t = entry["cells_per_tier"]
            ops_s = ((n_t[0] + n_t[1]) * per_cell / PEAK_INT8_OPS
                     + n_t[2] * per_cell / PEAK_FLOPS[dname])
            # the tier map (int32 a cell)
            t_bound, by = integer_gemm_bound_ms(
                m, k, n, 2 if dtype == torch.bfloat16 else 4, ops_s,
                4 * gm * gn)
            entry.update({"kernel_ms": t_kernel, "plain_ms": t_plain,
                          "library_ms": t_lib,
                          "library": "torch.matmul (the f32 product alone)",
                          "bound_ms": t_bound, "bound_by": by})
    # maps that lack a level at w1/wg: tiers {0, 2}, {2} only and {1} only
    # (the quantization skips each level the map lacks)
    k, n = cfg.d_model, cfg.d_ff
    a = torch.randn((CHUNK_M, k), generator=gen, device=dev).to(
        torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device=dev)
         / math.sqrt(k)).to(torch.bfloat16)
    gm, gn = CHUNK_M // ISLAND_BLOCK, n // ISLAND_BLOCK
    for present in ((0, 2), (2,), (1,)):
        pick = island_tiers(torch, gm, gn, dev) % len(present)
        tiers = torch.tensor(present, dtype=torch.int32, device=dev)[pick]
        entry = precision_case(torch, precision_island,
                               precision_island_plain, a, b, tiers,
                               f"precision_island w1/wg tiers {present}")
        held = {t for t in range(3) if entry["cells_per_tier"][t]}
        if held != set(present):
            fail(f"precision_island w1/wg tiers {present}: the map holds "
                 f"{entry['cells_per_tier']}")
        entry.update({"weight": f"w1/wg, tiers {list(present)} only"})
        out.append(entry)
    # ragged M, N, K, cells smaller than a launch tile (a block meets all
    # three tiers), and b as a transposed view
    for dtype in (torch.bfloat16, torch.float32):
        for transposed in (False, True):
            dname = str(dtype).replace("torch.", "")
            a = torch.randn((96, 100), generator=gen, device=dev).to(dtype)
            b = random_weight(torch, gen, 100, 80, dtype, transposed)
            tiers = island_tiers(torch, 3, 5, dev)
            entry = precision_case(
                torch, precision_island, precision_island_plain, a, b, tiers,
                f"precision_island ragged {dname} transposed={transposed}")
            entry["weight"] = ("ragged, b a transposed view" if transposed
                               else "ragged")
            out.append(entry)
    # the JAX tests' maps (test_precision_island_sweep) and one tier over a
    # whole (128, 256) x (256, 128) product (test_precision_tiers_order_error)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        a = torch.randn((256, 256), generator=gen, device=dev).to(dtype)
        b = torch.randn((256, 256), generator=gen, device=dev).to(dtype)
        for tmap in ([[0, 1], [2, 0]], [[2, 2], [2, 2]], [[0, 0], [0, 0]]):
            tiers = torch.tensor(tmap, dtype=torch.int32, device=dev)
            entry = precision_case(torch, precision_island,
                                   precision_island_plain, a, b, tiers,
                                   f"precision_island jax-test {tmap} {dname}")
            entry.update({"weight": "jax-test", "tiers": tmap})
            out.append(entry)
    a = torch.randn((128, 256), generator=gen, device=dev)
    b = torch.randn((256, 128), generator=gen, device=dev)
    exact = a @ b
    errs = []
    for tier in (0, 1, 2):
        tiers = torch.full((1, 1), tier, dtype=torch.int32, device=dev)
        entry = precision_case(torch, precision_island,
                               precision_island_plain, a, b, tiers,
                               f"precision_island one tier {tier}")
        errs.append(float((precision_island(a, b, tiers) - exact).abs()
                          .max()))
    if not (errs[0] > errs[1] > errs[2] and errs[2] < 1e-4):
        fail(f"precision_island: errors by tier {errs} are not ordered "
             f"int4 > int8 > f32 with f32 < 1e-4")
    out.append({"weight": "tier order", "M": 128, "K": 256, "N": 128,
                "dtype": "float32", "max_err_vs_exact_by_tier": errs})
    return out


def precision_islands(torch, cfg, islands, razor_kernels, precision_kernels,
                      select_blocks):
    """The precision-island loop at each full-width weight, on the kernels
    (counts set to 0 before, read after), then on the plain versions: every
    stage's result must be equal."""
    import numpy as np
    razor_matmul, razor_matmul_plain = razor_kernels
    precision_island, precision_island_plain = precision_kernels
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    operands = []
    for name, k, n in weight_shapes(cfg):
        a = torch.randn((CHUNK_M, k), generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev)
        w[0, 128:] *= 40.0                      # the example's outliers
        operands.append((name, a, w.to(torch.bfloat16)))
    torch.cuda.synchronize()

    # ---- the path: counts set to 0 just before, read just after
    razor_matmul.launches = 0
    precision_island.launches = 0
    runs = []
    for name, a, w in operands:
        t0 = time.monotonic()
        art = islands.run(a, w, block=ISLAND_BLOCK, tol=ISLAND_TOL)
        torch.cuda.synchronize()
        runs.append((art, time.monotonic() - t0, razor_matmul.launches,
                     precision_island.launches))
    launches = (razor_matmul.launches, precision_island.launches)

    def plain_razor(a, b, tol):
        bm, bn = select_blocks(a.shape[0], b.shape[1])
        return razor_matmul_plain(a, b, tol=tol, block_m=bm, block_n=bn)

    def plain_precision(a, b, tiers):
        gm, gn = tiers.shape
        return precision_island_plain(a, b, tiers, block_m=a.shape[0] // gm,
                                      block_n=b.shape[1] // gn)

    out, before = [], (0, 0)
    for (name, a, w), (art, seconds, n_razor, n_island) in zip(operands,
                                                               runs):
        ref = islands.run(a, w, block=ISLAND_BLOCK, tol=ISLAND_TOL,
                          razor=plain_razor, precision=plain_precision)
        for key in ("headroom", "static_tiers", "razor_flags", "tiers"):
            if not np.array_equal(art[key], ref[key]):
                fail(f"precision_islands {name}: {key} differs between the "
                     f"kernels and the plain versions")
        for key in ("energy_vs_bf16", "static_energy_vs_bf16"):
            if art[key] != ref[key]:
                fail(f"precision_islands {name}: {key} {art[key]} vs "
                     f"{ref[key]}")
        if not (math.isfinite(art.rel_error) and art.rel_error < 0.5
                and tuple(art.product.shape) == (a.shape[0], w.shape[1])):
            fail(f"precision_islands {name}: product of shape "
                 f"{tuple(art.product.shape)}, rel_error {art.rel_error}")
        # the tiered product itself: int4/int8 cells bit for bit, f32 cells
        # within TOL_CLEAN of max|C|; rel_error to TOL_REL of the plain one
        exact = cells_mask(torch, torch.as_tensor(art.tiers < 2, device=dev),
                           ISLAND_BLOCK, ISLAND_BLOCK)
        err, lim = compare_cells(torch, art.product, ref.product, exact,
                                 f"precision_islands {name} product")
        rel_gap = abs(art.rel_error - ref.rel_error)
        if not rel_gap <= TOL_REL * ref.rel_error:
            fail(f"precision_islands {name}: rel_error {art.rel_error} vs "
                 f"the plain route's {ref.rel_error}")
        out.append({
            "weight": name, "M": a.shape[0], "K": a.shape[1],
            "N": w.shape[1], "dtype": "bfloat16", "block": ISLAND_BLOCK,
            "tol": ISLAND_TOL,
            "razor_matmul_launches": n_razor - before[0],
            "precision_island_launches": n_island - before[1],
            "cells": int(art.tiers.size),
            "razor_flags_fired": int(art.razor_flags.sum()),
            "static_tiers_per_tier": np.bincount(art.static_tiers.ravel(),
                                                 minlength=3).tolist(),
            "tiers_per_tier": np.bincount(art.tiers.ravel(),
                                          minlength=3).tolist(),
            "integer_cells_bit_equal": True, "max_err_f32": err,
            "max_err_limit": lim,
            "rel_error": art.rel_error, "rel_error_plain": ref.rel_error,
            "energy_vs_bf16": art.energy_vs_bf16,
            "static_energy_vs_bf16": art.static_energy_vs_bf16,
            "equal_to_plain_route": True, "seconds": seconds})
        before = (n_razor, n_island)
    return launches, out


def kernel_name(key: str) -> str:
    """``razor_product_kernel<...>`` of a profiler row's demangled
    signature (the first ``*_kernel`` identifier), else the row's start."""
    import re
    hit = re.search(r"(\w+_kernel)\b", key)
    return hit.group(1) if hit else key[:64]


#: profiler sessions a measurement may take before it is left unmeasured
PROFILE_TRIES = 5
#: why a profiled measurement came back null, with what each try saw
PROFILE_MISSES = []


def profile_calls(torch, calls, repeats: int = 1):
    """Device time by CUDA kernel of one call of each wrapper (after the
    calls above warmed them up), by ``torch.profiler``: where a wrapper's
    time goes among its prologue, product and cell passes.

    Each session first traces one warm-up call that it discards (a
    ``schedule`` with one warm-up step: a session's first kernels can come
    back without device records), then the measured call.  A try counts
    only when every kernel row was seen a whole number of times
    ``repeats`` (``fn`` makes ``repeats`` identical calls): a session that
    lost some kernels' records (seen: 18 or 21 of a 24-call measurement's 24
    launches, and sessions with no device row at all, warm-up or not) is
    taken again.  Null after ``PROFILE_TRIES`` tries (not
    measured; the tries' kernel counts go to ``PROFILE_MISSES``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        seen = []
        for _ in range(PROFILE_TRIES):
            traced = []
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1),
                         on_trace_ready=lambda p: traced.append(
                             p.key_averages())) as prof:
                for _step in range(2):
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
            # kernels and memsets; not the schedule's own step annotation
            # ("ProfilerStep*"), which spans the step on the device too
            rows = [{"kernel": kernel_name(e.key),
                     "ms": e.self_device_time_total / 1e3, "calls": e.count}
                    for e in (traced[0] if traced else [])
                    if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep")]
            counts = [r["calls"] for r in rows]
            seen.append(counts)
            if rows and sum(r["ms"] for r in rows) > 0 and all(
                    c % repeats == 0 for c in counts):
                break
        else:
            PROFILE_MISSES.append({"what": name, "repeats": repeats,
                                   "kernel_counts_by_try": seen})
            out[name] = None
            continue
        rows.sort(key=lambda r: -r["ms"])
        out[name] = rows
    return out


def profile_serve(torch, serve_mod, params, backend="reference", extra=(),
                  pick=(), max_new=3):
    """A short run on ``backend`` (launcher flags ``extra`` added) under
    ``torch.profiler``: the device time of a model step by kernel, and the
    share of the run's wall time in which the device ran a kernel.  Tracing
    slows the host, so the share is a lower bound of an untraced run's.
    ``pick`` names kernels whose device ms a model step are reported apart
    (every row whose name holds the string, summed).  Where the profiler
    sees no device time, the numbers are null (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = serve_mod.parse_args(
        ["--arch", ARCH, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
         "--requests", str(SLOTS), "--max-new", str(max_new), "--backend",
         backend, *extra])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve_mod.run(args, params)
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in rows)
    steps = run.stats.model_steps
    if device_ms <= 0:
        return {"model_steps": steps, "decode_steps": run.stats.decode_steps,
                "device_ms_per_model_step": None,
                "device_busy_share_traced": None, "top_kernels": None,
                **({"picked_ms_per_model_step": None} if pick else {})}
    picked = {p: sum(ms for k, ms, _ in rows if p in k) / steps
              for p in pick}
    return {"model_steps": steps, "decode_steps": run.stats.decode_steps,
            "traced_wall_ms": 1e3 * run.wall_s,
            **({"picked_ms_per_model_step": picked} if pick else {}),
            "device_ms_per_model_step": device_ms / steps,
            "device_busy_share_traced": device_ms / (1e3 * run.wall_s),
            "kernels_per_model_step": sum(n for _, _, n in rows) / steps,
            # kernel launches alone (no copies or memsets)
            "launches_per_model_step": sum(
                n for k, _, n in rows
                if not k.startswith(("Memcpy", "Memset"))) / steps,
            "top_kernels": [{"name": k[:64], "ms_per_model_step": ms / steps,
                             "calls_per_model_step": n / steps}
                            for k, ms, n in rows[:6]]}


def serve(torch, cfg, serve_mod, model_api, param_count, use_backend,
          get_backend, systolic_mac):
    """The launcher's path at full width, ``backend="reference"``."""
    gemms_per_step = 7 * cfg.n_layers + 1
    argv = ["--arch", ARCH, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--requests", str(REQUESTS), "--max-new", str(MAX_NEW), "--mixed",
            "--seed", str(SEED)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    api = model_api(cfg)
    params = api.init_params(SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0

    # ---- warm-up, uncounted: the first use of every operator loads its
    # CUDA module, which would otherwise be charged to the first requests
    for backend in ("reference", "ideal"):
        serve_mod.run(serve_mod.parse_args(
            ["--arch", ARCH, "--slots", "2", "--max-len", str(MAX_LEN),
             "--requests", "2", "--max-new", "2", "--backend", backend]),
            params)
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after
    systolic_mac.launches = 0
    run = serve_mod.run(serve_mod.parse_args(argv + ["--backend",
                                                     "reference"]), params)
    torch.cuda.synchronize()
    launches = systolic_mac.launches
    stats = run.stats
    tel = stats.backend_telemetry
    steps = stats.decode_steps + stats.prefill_steps
    if stats.completed != REQUESTS or stats.truncated or stats.unserved:
        fail(f"serve: {stats.completed} of {REQUESTS} completed, "
             f"{stats.truncated} truncated, {stats.unserved} unserved")
    if launches != tel["calls"]:
        fail(f"serve: {launches} kernel launches for {tel['calls']} backend "
             f"GEMM calls")
    if tel["calls"] != gemms_per_step * steps:
        fail(f"serve: {tel['calls']} GEMMs, expected {gemms_per_step} x "
             f"{steps} model steps")
    if tel["flags"] != 0:
        fail(f"serve: {tel['flags']} flags at nominal rails")
    for r in run.requests:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab for t in r.out_tokens):
            fail(f"serve: request {r.uid} produced {r.out_tokens}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # ---- beside it: the same workload one slot at a time, and under ideal
    run1 = serve_mod.run(serve_mod.parse_args(
        argv[:2] + ["--slots", "1"] + argv[4:] + ["--backend", "reference"]),
        params)
    same_as_one_slot = all(a.out_tokens == b.out_tokens for a, b in
                           zip(run.requests, run1.requests))
    ideal = serve_mod.run(serve_mod.parse_args(argv + ["--backend", "ideal"]),
                          params)
    pairs = [(x, y) for a, b in zip(run.requests, ideal.requests)
             for x, y in zip(a.out_tokens, b.out_tokens)]
    agree = sum(x == y for x, y in pairs) / len(pairs)

    # ---- where a served step's time goes: a short profiled run
    profile = profile_serve(torch, serve_mod, params)

    # ---- prefill logits of one prompt, reference against ideal
    toks = torch.as_tensor([run.requests[0].prompt], device="cuda")
    with use_backend(get_backend("reference")):
        lg_ref, _ = api.prefill(params, {"tokens": toks}, max_len=MAX_LEN)
    lg_ideal, _ = api.prefill(params, {"tokens": toks}, max_len=MAX_LEN)
    if tuple(lg_ref.shape) != (1, cfg.padded_vocab) or not bool(
            torch.isfinite(lg_ref).all()):
        fail(f"serve: prefill logits of shape {tuple(lg_ref.shape)} or not "
             f"finite")
    scale = float(lg_ideal.abs().max())
    err = float((lg_ref - lg_ideal).abs().max())
    if not err <= TOL_LOGITS * scale:
        fail(f"serve: prefill logits differ from ideal by {err} (limit "
             f"{TOL_LOGITS * scale})")

    return launches, params, run, {
        "arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": param_count(params), "backend": "reference",
        "slots": SLOTS, "max_len": MAX_LEN, "requests": REQUESTS,
        "completed": stats.completed, "prefill_steps": stats.prefill_steps,
        "decode_steps": stats.decode_steps,
        "tokens_generated": stats.tokens_generated,
        "gemm_calls": tel["calls"], "kernel_launches": launches,
        "macs": tel["macs"], "flags": tel["flags"],
        "wall_s": run.wall_s,
        "model_step_ms": 1e3 * run.wall_s / steps,
        "tokens_per_s": stats.tokens_generated / run.wall_s,
        "ttft_mean_s": sum(stats.ttft_s) / len(stats.ttft_s),
        "init_params_s": init_s, "peak_device_memory_gb": peak_gb,
        "tokens_equal_to_slots_1": same_as_one_slot,
        "ideal_tokens_per_s": ideal.stats.tokens_generated / ideal.wall_s,
        "ideal_model_step_ms": 1e3 * ideal.wall_s / ideal.stats.model_steps,
        "token_agreement_reference_vs_ideal": agree,
        "prefill_logits_max_err_vs_ideal": err,
        "prefill_logits_max_err_limit": TOL_LOGITS * scale,
        "profile": profile}


# ---------------------------------------------------------------------------
# hwloop: the simulated and emulated voltage-island arrays
# ---------------------------------------------------------------------------


def hwloop_flow_config(tflow):
    """The operating point ``launch.serve --hwloop`` builds."""
    return tflow.FlowConfig(array_n=8, tech="vtr-22nm", max_trials=8,
                            seed=2021)


def hwloop_case(torch, np, kind, shape, seed):
    """(a, w) on the card, and the float64 host arrays the loop gets:
    ``bf16T`` real-valued bf16 with the weight a transposed view (as the
    model's tied unembedding is), ``int`` integer-valued bf16."""
    m, k, n = shape
    gen = np.random.default_rng(seed)
    a, w = gen.normal(size=(m, k)), gen.normal(size=(k, n))
    if kind == "int":
        a, w = np.round(3 * a), np.round(3 * w)
    ta = torch.as_tensor(a, device=DEVICE).to(torch.bfloat16)
    tw = torch.as_tensor(w.T.copy(), device=DEVICE).to(torch.bfloat16).T
    return ta, tw, ta.double().cpu().numpy(), tw.double().cpu().numpy()


def hwloop_check(torch, what, c, c_ref, got, want, exact, simulated):
    """The tiled form's result against the loop's: every count, flag and
    ledger total equal; products within TOL_TILED x max|C|, and bit-equal
    where ``exact`` (integer-valued operands under a model whose outputs
    stay integers: not ``bitflip``, whose flipped bit 40 makes a zero sum a
    subnormal that an integer added before or after it keeps or loses);
    rel_error within TOL_TILED_REL relative (the simulated loop's clean
    tiles report a rounding gap below 1e-15 that the tiled form reports as
    0.0)."""
    c_ref = torch.as_tensor(c_ref)
    c = c.cpu()
    err = float((c - c_ref).abs().max())
    scale = float(c_ref.abs().max())
    if exact and not torch.equal(c, c_ref):
        fail(f"hwloop_checks {what}: integer-valued product not bit-equal "
             f"(max err {err})")
    if not err <= TOL_TILED * scale:
        fail(f"hwloop_checks {what}: product off by {err} (limit "
             f"{TOL_TILED * scale})")
    rel, rel_ref = got.pop("rel_error"), want.pop("rel_error")
    if simulated and rel_ref < 1e-12:
        ok = rel == 0.0 and rel_ref < 1e-15
    else:
        ok = abs(rel - rel_ref) <= TOL_TILED_REL * rel_ref
    if not ok:
        fail(f"hwloop_checks {what}: rel_error {rel}, loop {rel_ref}")
    if got != want:
        fail(f"hwloop_checks {what}: counts differ: {got} vs {want}")
    return err / scale if scale else 0.0, rel_ref


def hwloop_checks(torch, np, tflow, thw, SimulatedBackend, tiled):
    """The tiled form on the card against its plain version, the loop on
    the same inputs: both rules, rails at nominal, just below the safe
    point and deep in the crash region, the three corruption models, a
    silent-tile chunk of one K-tile, real and integer-valued bf16 operands
    with the weight a transposed view.  Then the tiled form's time a call
    at each shape (nominal rails, bf16)."""
    import copy
    from repro_torch.core import RazorConfig, SystolicSim, TimingModel
    fcfg = hwloop_flow_config(tflow)
    report = tflow.run(fcfg)
    tm = TimingModel(n=fcfg.array_n, clock_ns=fcfg.clock_ns, tech=fcfg.node,
                     seed=fcfg.seed)
    rails = {"nominal": fcfg.node.v_nom,
             "detect": float(tm.min_safe_voltage().max()) - 0.02,
             "deep": 0.58}
    combos = ([("emulated", "stale", lv, None) for lv in rails]
              + [("emulated", c, "deep", None) for c in ("tedrop", "bitflip")]
              + [("emulated", "stale", "deep", 1)]
              + [("simulated", "stale", lv, None) for lv in rails]
              + [("simulated", "stale", "deep", 1)])
    rows, worst_err = [], 0.0
    terms_chunk = tiled.TERMS_CHUNK_BYTES
    for shape in HWLOOP_SHAPES:
        for kind in ("bf16T", "int"):
            ta, tw, a, w = hwloop_case(torch, np, kind, shape, sum(shape))
            for rule, corruption, level, chunk in combos:
                what = f"{rule}/{corruption}/{level}/{kind} {shape}"
                # chunk 1: one silent K-tile a term tensor
                tiled.TERMS_CHUNK_BYTES = 1 if chunk else terms_chunk
                t0 = time.perf_counter()
                if rule == "emulated":
                    acc = thw.EmulatedAccelerator.from_flow(
                        report, fcfg, corruption=corruption,
                        rails=np.full(report.n_partitions, rails[level]))
                    loop = copy.deepcopy(acc)
                    c_ref, t_ref = loop._matmul_loop(a, w)
                    loop_s = time.perf_counter() - t0
                    c, t = acc._matmul_tiled(ta, tw)
                    if acc.ledger.summary() != loop.ledger.summary():
                        fail(f"hwloop_checks {what}: ledger totals differ")
                    keys = ("detected_p", "silent_p", "macs_p",
                            "partition_flags")
                    got = {k: getattr(t, k).tolist() for k in keys}
                    want = {k: getattr(t_ref, k).tolist() for k in keys}
                    for d, tel in ((got, t), (want, t_ref)):
                        d.update(replay_cycles=tel.replay_cycles,
                                 cycles=tel.cycles, rel_error=tel.rel_error)
                    silent = int(t_ref.silent_p.sum())
                else:
                    fp = report.floorplan.with_voltages(
                        [rails[level]] * report.n_partitions)
                    be = SimulatedBackend(SystolicSim(
                        tm, fp, RazorConfig(clock_ns=fcfg.clock_ns)))
                    c_ref, t_ref = be._execute_loop(a, w)
                    loop_s = time.perf_counter() - t0
                    c, t = be._execute_tiled(ta, tw)
                    got, want = t.to_dict(), t_ref.to_dict()
                    silent = t_ref.silent
                err, rel_ref = hwloop_check(
                    torch, what, c, c_ref, got, want,
                    kind == "int" and corruption != "bitflip",
                    rule == "simulated")
                worst_err = max(worst_err, err)
                rows.append({"case": what, "one_k_tile_a_chunk": bool(chunk),
                             "silent": silent, "rel_error": rel_ref,
                             "max_err_over_max_c": err,
                             "loop_s": loop_s})
                if level == "deep" and not silent:
                    fail(f"hwloop_checks {what}: no silent MAC in the crash "
                         f"region")
    tiled.TERMS_CHUNK_BYTES = terms_chunk

    # ---- the tiled form's time a call, nominal rails, bf16 operands
    timed = []
    for shape in HWLOOP_SHAPES:
        ta, tw, _, _ = hwloop_case(torch, np, "bf16T", shape, 1)
        acc = thw.EmulatedAccelerator.from_flow(
            report, fcfg, rails=np.full(report.n_partitions, rails["nominal"]))
        fp = report.floorplan.with_voltages([rails["nominal"]] * 4)
        be = SimulatedBackend(SystolicSim(tm, fp,
                                          RazorConfig(clock_ns=fcfg.clock_ns)))
        for rule, fn in (("emulated", lambda: acc._matmul_tiled(ta, tw)),
                         ("simulated", lambda: be._execute_tiled(ta, tw))):
            fn()
            torch.cuda.synchronize()
            host, wall = [], []
            for _ in range(9):
                t0 = time.perf_counter()
                fn()
                host.append(1e3 * (time.perf_counter() - t0))
                torch.cuda.synchronize()
                wall.append(1e3 * (time.perf_counter() - t0))
            timed.append({"rule": rule, "shape": list(shape),
                          "host_ms_per_call": sorted(host)[4],
                          "wall_ms_per_call": sorted(wall)[4],
                          "device_ms_per_call": device_ms(
                              lambda i: fn(), 1, 5)})
    return {"cases": len(rows), "rows": rows,
            "worst_err_over_max_c": worst_err, "tol": TOL_TILED,
            "tol_rel_error": TOL_TILED_REL, "timed": timed}


def tokens_up_to_ties(torch, got_reqs, want_reqs, logits_of, what):
    """``got``'s tokens equal ``want``'s, or at the first step where they
    part ``got``'s token lies within 2 x TOL_LOGITS of max|logits| of the
    top of ``logits_of(request, fed)`` (the C1 rule).  Returns the number
    of requests that parted and the largest gap at a parting."""
    parted, worst = 0, 0.0
    for r_got, r_want in zip(got_reqs, want_reqs):
        a, b = r_got.out_tokens, r_want.out_tokens
        if len(a) != len(b):
            fail(f"{what}: request {r_got.uid} gave {len(a)} tokens, "
                 f"{len(b)} expected")
        if a == b:
            continue
        parted += 1
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = logits_of(r_want, b[:i])
        gap = float(lg.max() - lg[a[i]]) / float(lg.abs().max())
        worst = max(worst, gap)
        if gap > 2 * TOL_LOGITS:
            fail(f"{what}: request {r_got.uid} parts at token {i} with a gap "
                 f"of {gap} of max|logits| (limit {2 * TOL_LOGITS})")
    return parted, worst


def serve_hwloop(torch, cfg, mods, params, ref, counters, tiled):
    """phi4-mini-3.8b at full width on the emulated array, through the
    launcher (``--backend emulated --hwloop``), with the ``serve`` phase's
    weights and traffic; then the Algorithm-2 watchdog healing an
    undervolted rail on the live serving device; then a short run on the
    simulated array."""
    import numpy as np
    serve_mod = mods.serve
    gemms = dense_gemms(cfg)
    per_step = sum(g[2] for g in gemms.values())
    # a prefill multiplies every prompt row by the layers' weights and only
    # the last row by the unembedding; a decode step, every slot's row
    logits_kn = gemms["logits"][0] * gemms["logits"][1]
    layers_kn = sum(k * n * per for k, n, per, _, _ in gemms.values()) \
        - logits_kn
    argv = ["--arch", ARCH, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--requests", str(REQUESTS), "--max-new", str(MAX_NEW), "--mixed",
            "--seed", str(SEED)]
    short = ["--arch", ARCH, "--slots", "2", "--max-len", str(MAX_LEN),
             "--requests", "2", "--max-new", "2", "--mixed", "--seed",
             str(SEED)]
    api = mods.model_api(cfg)

    def logits_of(backend):
        return lambda req, fed: logits_alone(
            torch, api, params, req.prompt, fed, backend, mods.use_backend,
            mods.get_backend, mods.ShapeConfig)

    # ---- warm-up, uncounted; its tokens are the simulated run's reference
    emu_short = serve_mod.run(serve_mod.parse_args(
        short + ["--backend", "emulated"]), params)
    torch.cuda.synchronize()

    # ---- 1. the main path: counts set to 0 just before, read just after
    counters.zero()
    tiled.tiled_matmul.calls = tiled.tiled_matmul.reads = 0
    torch.cuda.reset_peak_memory_stats()
    run = serve_mod.run(serve_mod.parse_args(
        argv + ["--backend", "emulated", "--hwloop"]), params)
    torch.cuda.synchronize()
    launches = counters.read()
    calls, reads = tiled.tiled_matmul.calls, tiled.tiled_matmul.reads
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats, tel, hw = run.stats, run.stats.backend_telemetry, run.stats.hwloop
    steps = stats.model_steps
    if stats.completed != REQUESTS or stats.truncated or stats.unserved:
        fail(f"serve_hwloop: {stats.completed} of {REQUESTS} completed, "
             f"{stats.truncated} truncated, {stats.unserved} unserved")
    if any(launches.values()):
        fail(f"serve_hwloop: kernels launched on the emulated path: "
             f"{launches}")
    if not calls == tel["calls"] == per_step * steps:
        fail(f"serve_hwloop: {calls} tiled-form calls, {tel['calls']} "
             f"backend GEMMs, expected {per_step} x {steps} model steps")
    decode_rows = SLOTS * stats.decode_steps
    macs_expected = (
        layers_kn * (sum(len(r.prompt) for r in run.requests) + decode_rows)
        + logits_kn * (stats.prefill_steps + decode_rows))
    if tel["macs"] != macs_expected:
        fail(f"serve_hwloop: {tel['macs']} MACs, expected the sum of M*K*N "
             f"over the GEMMs, {macs_expected}")
    if hw is None or hw["steps"] != stats.decode_steps:
        fail(f"serve_hwloop: the watchdog saw {hw and hw['steps']} of "
             f"{stats.decode_steps} decode steps")
    if not (tel["energy_per_token_j"] and tel["energy_per_token_j"] > 0):
        fail(f"serve_hwloop: energy per token {tel['energy_per_token_j']}")
    # the calibrated rails keep their guard band: no flag, no silent MAC
    if tel["flags"] != 0 or tel["silent"] != 0:
        fail(f"serve_hwloop: {tel['flags']} flags, {tel['silent']} silent "
             f"at the calibrated rails")
    parted, gap = tokens_up_to_ties(
        torch, run.requests, ref.requests, logits_of("reference"),
        "serve_hwloop against reference")
    _, cb_s, cb_n = run.engine.obs.registry.histogram(
        "backend_callback_seconds", labels=("backend",)).snapshot(
            backend="emulated")
    main = {"backend": "emulated", "hwloop": True,
            "completed": stats.completed,
            "prefill_steps": stats.prefill_steps,
            "decode_steps": stats.decode_steps, "model_steps": steps,
            "tokens_generated": stats.tokens_generated,
            "gemm_calls": tel["calls"], "tiled_form_calls": calls,
            "kernel_launches": launches, "macs": tel["macs"],
            "macs_expected": macs_expected,
            "flags": tel["flags"], "replays": tel["replays"],
            "silent": tel["silent"],
            "energy_per_token_j": tel["energy_per_token_j"],
            "recalibrations": hw["recalibrations"],
            "rails_v": hw["rails_v"], "flag_rate": hw["flag_rate"],
            "wall_s": run.wall_s,
            "tokens_per_s": stats.tokens_generated / run.wall_s,
            "ttft_mean_s": sum(stats.ttft_s) / len(stats.ttft_s),
            "model_step_ms": 1e3 * run.wall_s / steps,
            "reference_model_step_ms": ref.model_step_ms,
            "host_ms_per_gemm": 1e3 * cb_s / cb_n,
            "device_reads": reads,
            "device_reads_per_model_step": reads / steps,
            "peak_device_memory_gb": peak_gb,
            "reference_peak_device_memory_gb": ref.peak_gb,
            "tokens_vs_reference": {
                "requests_parting": parted, "worst_gap_at_parting": gap,
                "tie_limit": 2 * TOL_LOGITS}}

    # the serve_guard phase holds its guarded run against this one
    ref.emulated_requests = run.requests
    ref.emulated_step_ms = main["model_step_ms"]
    ref.emulated_host_ms_per_gemm = main["host_ms_per_gemm"]

    # ---- where an emulated step's time goes: a short profiled run
    main["profile"] = profile_serve(torch, serve_mod, params, "emulated")

    # ---- 2. the thin adapter: undervolt partition 0 on the serving device
    from repro_torch.backend import EmulatedBackend
    from repro_torch.flow import FlowConfig
    from repro_torch.hwloop import HwLoopSession
    session = HwLoopSession(FlowConfig(array_n=8, tech="vtr-22nm",
                                       max_trials=8, seed=2021),
                            probe_rows=8, rail_margin=0.02, patience=2)
    be = EmulatedBackend(session.accel)
    acc = be.accel
    v_safe = float(acc.timing.min_safe_voltage()[acc._part_grid == 0].max())
    session.set_partition_voltage(0, v_safe - 0.02)
    undervolt = float(acc.rails[0])
    eng = mods.ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                           backend=be, hwloop=session)
    for req in serve_mod.make_requests(cfg, 3, 4, False, SEED):
        eng.submit(req)
    flags = eng.stats.backend_step_flags
    healed_at = None             # decode steps seen when the heal landed
    t0 = time.monotonic()
    while not eng.scheduler.drained():
        eng.step()
        if healed_at is None and session.recalibrations:
            healed_at = len(flags)
    heal_s = time.monotonic() - t0
    if not any(f[0] for f in flags):
        fail("serve_hwloop: partition 0's flag never fired under the "
             "undervolt")
    if session.recalibrations < 1:
        fail("serve_hwloop: the watchdog never recalibrated")
    if not acc.rails[0] > undervolt:
        fail(f"serve_hwloop: rail 0 at {acc.rails[0]}, not above the "
             f"undervolt {undervolt}")
    # steps after the first recalibration, then a fresh drain: no flag
    after = flags[healed_at:]
    eng2 = mods.ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                            backend=be, hwloop=session)
    for req in serve_mod.make_requests(cfg, 2, 2, False, SEED + 1):
        eng2.submit(req)
    healed = eng2.run_until_drained()
    after = after + healed.backend_step_flags
    if any(any(f) for f in after):
        fail(f"serve_hwloop: flags after the heal: {after}")
    adapter = {"requests": 3, "max_new": 4, "undervolt_v": undervolt,
               "v_safe_partition_0": v_safe,
               "decode_steps": eng.stats.decode_steps,
               "partition_0_flag_steps": sum(f[0] for f in flags),
               "healed_after_decode_steps": healed_at,
               "recalibrations": session.recalibrations,
               "rails_v_after": [float(v) for v in acc.rails],
               "clean_steps_after_heal": len(after),
               "silent": be.total.silent, "seconds": heal_s}

    # ---- 3. the simulated array: clean, and the emulated run's tokens
    sim = serve_mod.run(serve_mod.parse_args(
        short + ["--backend", "simulated"]), params)
    sim_tel = sim.stats.backend_telemetry
    if sim_tel["flags"] != 0 or sim_tel["silent"] != 0:
        fail(f"serve_hwloop: the simulated array at nominal rails raised "
             f"{sim_tel['flags']} flags, {sim_tel['silent']} silent")
    sim_parted, sim_gap = tokens_up_to_ties(
        torch, sim.requests, emu_short.requests, logits_of("emulated"),
        "serve_hwloop simulated against emulated")
    simulated = {"requests": 2, "max_new": 2,
                 "completed": sim.stats.completed,
                 "gemm_calls": sim_tel["calls"], "macs": sim_tel["macs"],
                 "flags": sim_tel["flags"], "wall_s": sim.wall_s,
                 "model_step_ms": 1e3 * sim.wall_s / sim.stats.model_steps,
                 "requests_parting_from_emulated": sim_parted,
                 "worst_gap_at_parting": sim_gap}
    return {"arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "slots": SLOTS, "max_len": MAX_LEN, "requests": REQUESTS,
            "gemms_per_model_step": per_step, "emulated": main,
            "thin_adapter_undervolt": adapter, "simulated": simulated}


# ---------------------------------------------------------------------------
# The ABFT guard (resilience/) and the rail autoscaler (railscale/)
# ---------------------------------------------------------------------------


def abft_bound_ms(k, n, elem, r, nu, m=0):
    """Least time for one abft_checksums call on a (K, N) operand: b read
    once, the float64 vectors read once and the outputs written once,
    against 2 K N flops a vector at the float64 peak.  The general form:
    ``r`` columns of v and ``nu`` rows of u; the abft mode (``m`` > 0): a
    (M, K) read once, the (2, M + N) pack written, and four vectors (b 1,
    |b| 1 and a's sums times b and |b|)."""
    if m:
        nbytes = elem * (k * n + m * k) + 8 * 2 * (m + n)
        flops = 2.0 * k * n * 4 + 2.0 * m * k * 4
    else:
        nbytes = elem * k * n + 8 * (n * r + k * nu) + 8 * (k * (r + 1)
                                                            + nu * n)
        flops = 2.0 * k * n * (r + 1 + nu)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float64"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def verdict_bound_ms(m, n, elem):
    """Least time for one abft_verdict call: the (M, N) product and the
    (2, M + N) checks read once, seven doubles written; M N + ... adds at
    the float64 peak."""
    nbytes = elem * m * n + 8 * 2 * (m + n) + 8 * 7
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n / PEAK_FLOPS["float64"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def abft_vectors(torch, gen, a, n, r):
    """The general form's arguments for an (M, K) ``a`` and an N-wide
    product: the abft mode's vectors (ones; a's column sums and, against
    |b|, |a|'s) for ``r == 0``, else ``r`` Freivalds probes and no u."""
    dev = a.device
    a64 = a.to(torch.float64)
    if r == 0:
        return (torch.ones((n, 1), dtype=torch.float64, device=dev),
                torch.stack([a64.sum(dim=0), a64.abs().sum(dim=0)]), 1)
    probes = torch.randint(0, 2, (n, r), generator=gen, device=dev)
    return (probes.to(torch.float64) * 2 - 1, a64[:0], 0)


def abft_case(torch, abft, plain, b, args, what):
    """One call of the general form against its plain version, and a
    repeated call: the largest error as a fraction of the sums of
    magnitudes (the float64 sums are taken in another order), bit-equal on
    repeat."""
    got = abft(b, *args)
    again = abft(b, *args)
    torch.cuda.synchronize()
    want = plain(b, *args)
    babs = b.to(torch.float64).abs()
    scales = [babs.sum(dim=1, keepdim=True), args[1].abs() @ babs]
    err = 0.0
    for g, w, s in zip(got, want, scales):
        if g.shape != w.shape:
            fail(f"abft_checksums {what}: shape {tuple(g.shape)}, expected "
                 f"{tuple(w.shape)}")
        if g.numel():
            e = float(((g - w).abs() / s.clamp_min(1e-300)).max())
            if not math.isfinite(e):
                fail(f"abft_checksums {what}: non-finite error")
            err = max(err, e)
    if err > TOL_ABFT:
        fail(f"abft_checksums {what}: error {err} of the magnitude sums "
             f"over the limit {TOL_ABFT}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"abft_checksums {what}: a repeated call gave other bits")
    return err


def abft_pack_case(torch, abft, plain, b, a, what):
    """The abft mode (the guard's call) against its plain version, and a
    repeated call: each reference as a fraction of its sum of magnitudes,
    each tolerance of its own; bit-equal on repeat."""
    got = abft(b, a=a, tol=GUARD_TOL)
    again = abft(b, a=a, tol=GUARD_TOL)
    torch.cuda.synchronize()
    want = plain(b, a=a, tol=GUARD_TOL)
    if got.shape != want.shape:
        fail(f"abft_checksums {what}: pack {tuple(got.shape)}, expected "
             f"{tuple(want.shape)}")
    a64, b64 = a.to(torch.float64).abs(), b.to(torch.float64).abs()
    mags = torch.cat([a64 @ b64.sum(dim=1), a64.sum(dim=0) @ b64])
    del b64
    scale = torch.stack([mags, (mags + 1.0) * GUARD_TOL]).clamp_min(1e-300)
    err = float(((got - want).abs() / scale).max())
    if not math.isfinite(err) or err > TOL_ABFT:
        fail(f"abft_checksums {what}: error {err} of the magnitude sums "
             f"over the limit {TOL_ABFT}")
    if not torch.equal(got, again):
        fail(f"abft_checksums {what}: a repeated call gave other bits")
    return err


def verdict_case(torch, verdict, plain, out, checks, what):
    """abft_verdict against its plain version on one product, and a
    repeated call: counts and first indices equal, the residuals within
    TOL_ABFT of their rows' and columns' magnitude sums (the largest ratio
    within as much over its tolerance), bit-equal on repeat."""
    got = verdict(out, checks)
    again = verdict(out, checks)
    torch.cuda.synchronize()
    want = plain(out, checks)
    g, w = got.tolist(), want.tolist()
    if g[:4] != w[:4]:
        fail(f"abft_verdict {what}: counts and first indices {g[:4]}, the "
             f"plain version's {w[:4]}")
    o64 = out.to(torch.float64).abs()
    mags = torch.cat([o64.sum(dim=1), o64.sum(dim=0)]) + checks[0].abs()
    m = out.shape[0]
    err_r = abs(g[4] - w[4]) / float(mags[int(g[2])])
    err_c = abs(g[5] - w[5]) / float(mags[m + int(g[3])])
    err_w = abs(g[6] - w[6]) / float((mags / checks[1]).max())
    err = max(err_r, err_c, err_w)
    if not math.isfinite(err) or err > TOL_ABFT:
        fail(f"abft_verdict {what}: residual error {err} of the magnitude "
             f"sums over the limit {TOL_ABFT} ({g} against {w})")
    if not torch.equal(got, again):
        fail(f"abft_verdict {what}: a repeated call gave other bits")
    return {"bad_rows": g[0], "bad_cols": g[1], "first_bad": [g[2], g[3]],
            "max_err": err, "max_err_limit": TOL_ABFT,
            "equal_to_plain": True, "repeat_bit_equal": True}


def check_abft(torch, cfg, abft_mod, GuardedBackend, get_backend):
    """abft_checksums against its plain version: at phi4-mini's weights as
    the model holds them (bf16, the logits a transposed view), the abft mode
    (the guard's call) for a decode step's rows (M 4) and a prefill chunk's
    (M 256), and two Freivalds probes; f32, float64, ragged and strided
    operands; five probes (two launches).  abft_verdict against its plain
    version on seeded corrupted products at each weight's width, bf16, f32
    and f64.  Then the guard's verdicts on seeded corrupted products, on the
    card against the CPU's plain route; and the times of the two calls the
    guard makes at each weight."""
    abft, plain = abft_mod.abft_checksums, abft_mod.abft_checksums_plain
    verdict, vplain = abft_mod.abft_verdict, abft_mod.abft_verdict_plain
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    rows, vrows = [], []
    gemms = dense_gemms(cfg)
    for name, (k, n, per_step, transposed, dname) in gemms.items():
        b = model_weight(torch, gen, k, n, torch.bfloat16, transposed)
        for m, r in ((DECODE_M, 0), (CHUNK_M, 0), (DECODE_M, 2)):
            a = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            what = f"{name} M={m} r={r}"
            err = (abft_pack_case(torch, abft, plain, b, a, what) if r == 0
                   else abft_case(torch, abft, plain, b,
                                  abft_vectors(torch, gen, a, n, r), what))
            rows.append({"weight": name, "K": k, "N": n, "M": m,
                         "dtype": "bfloat16", "b_transposed_view": transposed,
                         "mode": "abft" if r == 0 else f"freivalds r={r}",
                         "max_err": err, "max_err_limit": TOL_ABFT,
                         "repeat_bit_equal": True})
        # the verdict on this weight's products (M 4), clean and corrupted
        a = torch.randn((DECODE_M, k), generator=gen, device=dev).to(
            torch.bfloat16)
        checks = abft(b, a=a, tol=GUARD_TOL)
        clean = a.to(torch.float64) @ b.to(torch.float64)
        scale = float(clean.abs().max())
        for what, hits in (("clean", []),) + CORRUPTIONS:
            prod = clean.clone()
            for i, j, f in hits:
                prod[i, j] += f * scale
            for dtype in (torch.bfloat16, torch.float32, torch.float64):
                dn = str(dtype).split(".")[1]
                row = verdict_case(torch, verdict, vplain, prod.to(dtype),
                                   checks, f"{name} {what} {dn}")
                if hits and not row["bad_rows"] + row["bad_cols"]:
                    fail(f"abft_verdict {name} {what} {dn}: not detected")
                vrows.append({"weight": name, "N": n, "M": DECODE_M,
                              "product_dtype": dn, "corruption": what, **row})
        del b, clean
    others = (("f32", 3072, 1024, torch.float32, False, 0),
              ("f32 transposed", 1000, 4096, torch.float32, True, 0),
              ("ragged bf16", 1000, 333, torch.bfloat16, False, 0),
              ("ragged f32 transposed, 4 probes", 77, 1001, torch.float32,
               True, 4),
              ("float64", 5, 3, torch.float64, False, 0),
              ("bf16, 5 probes (two launches)", 3072, 3072, torch.bfloat16,
               False, 5))
    for what, k, n, dtype, transposed, r in others:
        b = model_weight(torch, gen, k, n, dtype, transposed)
        a = torch.randn((DECODE_M, k), generator=gen, device=dev).to(dtype)
        err = (abft_pack_case(torch, abft, plain, b, a, what) if r == 0
               else abft_case(torch, abft, plain, b,
                              abft_vectors(torch, gen, a, n, r), what))
        rows.append({"weight": what, "K": k, "N": n, "M": DECODE_M,
                     "dtype": str(dtype).split(".")[1],
                     "b_transposed_view": transposed, "probes": r,
                     "max_err": err, "max_err_limit": TOL_ABFT})
    # a strided view (every other column of a wider table): both forms
    wide = torch.randn((1024, 2 * 777), generator=gen, device=dev).to(
        torch.bfloat16)
    b = wide[:, ::2]
    a = torch.randn((DECODE_M, 1024), generator=gen, device=dev).to(
        torch.bfloat16)
    err = max(abft_pack_case(torch, abft, plain, b, a, "strided view"),
              abft_case(torch, abft, plain, b,
                        abft_vectors(torch, gen, a, 777, 0), "strided view"))
    rows.append({"weight": "strided view (1024, 777) of (1024, 1554)",
                 "K": 1024, "N": 777, "dtype": "bfloat16", "max_err": err,
                 "max_err_limit": TOL_ABFT})

    verdicts = abft_verdicts(torch, gen, GuardedBackend, get_backend)

    # the guard's two calls at each weight (abft mode, M = 4; B1's f32
    # product), timed
    timed = []
    for name, (k, n, per_step, transposed, dname) in gemms.items():
        copies = max(1, math.ceil(120e6 / (2 * k * n)))
        bs = [model_weight(torch, gen, k, n, torch.bfloat16, transposed)
              for _ in range(copies)]
        a = torch.randn((DECODE_M, k), generator=gen, device=dev).to(
            torch.bfloat16)
        iters = 4 if transposed else 24

        def kernel(i):
            return abft(bs[i], a=a, tol=GUARD_TOL)

        def library(i):
            return torch.mv(bs[i].to(torch.float64),
                            torch.ones((n,), dtype=torch.float64, device=dev))

        checks = kernel(0)
        outs = [(a.to(torch.float32) @ bs[0].to(torch.float32))
                for _ in range(4)]

        def judge(i):
            return verdict(outs[i % 4], checks)

        t_bound, by = abft_bound_ms(k, n, 2, 0, 0, m=DECODE_M)
        v_bound, v_by = verdict_bound_ms(DECODE_M, n, 4)
        row = {"weight": name, "K": k, "N": n, "M": DECODE_M,
               "b_transposed_view": transposed,
               "launches_per_model_step": per_step,
               "plan": dataclasses.asdict(abft_mod.launch_plan(
                   *((n, k) if transposed else (k, n)), torch.bfloat16)),
               "kernel_ms": time_ms(kernel, copies, iters),
               "device_ms": device_ms(kernel, copies, iters),
               "plain_ms": time_ms(
                   lambda i: plain(bs[i], a=a, tol=GUARD_TOL), copies,
                   max(2, iters // 4)),
               "library_ms": time_ms(library, copies, iters),
               "library": "torch.mv of a float64 copy of b by ones (the "
                          "copy included): one of the four vectors",
               "bound_ms": t_bound, "bound_by": by,
               "verdict": {
                   "product_dtype": "float32",
                   "kernel_ms": time_ms(judge, 4, 24),
                   "device_ms": device_ms(judge, 4, 24),
                   "plain_ms": time_ms(lambda i: vplain(outs[i % 4], checks),
                                       4, 8),
                   "bound_ms": v_bound, "bound_by": v_by}}
        if name == "w1/wg":
            row["host_us_per_call"] = host_us_per_call(
                torch, lambda: abft(bs[0], a=a, tol=GUARD_TOL), 200, 5)
            row["verdict"]["host_us_per_call"] = host_us_per_call(
                torch, lambda: verdict(outs[0], checks), 200, 5)
        timed.append(row)
        del bs, outs
    torch.cuda.empty_cache()
    return rows, vrows, verdicts, timed


#: (what, [(row, col, delta as a fraction of max|C|)]): one corrupted
#: element (located and corrected), two in other rows and columns, two in
#: one column, a whole row
CORRUPTIONS = (
    ("one element", [(1, 7, 0.5)]),
    ("two elements", [(0, 3, 0.5), (2, 11, -0.25)]),
    ("two in one column", [(0, 5, 0.5), (3, 5, 0.5)]),
    ("a whole row", [(2, j, 0.01 * (j + 1)) for j in range(64)]))


def abft_verdicts(torch, gen, GuardedBackend, get_backend):
    """The guard's verification of seeded corrupted products on the card
    (the kernel route) against the CPU's (the plain route), at three phi4
    weight shapes: the same bad rows and columns, the same first ones, and
    the same corrected element."""
    dev = torch.device(DEVICE)
    out = []
    for k, n, transposed in ((3072, 3072, False), (8192, 3072, False),
                             (3072, 8192, True)):
        a = torch.randn((DECODE_M, k), generator=gen, device=dev).to(
            torch.bfloat16)
        b = model_weight(torch, gen, k, n, torch.bfloat16, transposed)
        clean = a.to(torch.float64) @ b.to(torch.float64)
        scale = float(clean.abs().max())
        a_cpu, b_cpu = a.cpu(), b.cpu()
        guards = {"cuda": GuardedBackend(get_backend("ideal")),
                  "cpu": GuardedBackend(get_backend("ideal", device="cpu"))}
        checks = {"cuda": guards["cuda"]._checks(a, b),
                  "cpu": guards["cpu"]._checks(a_cpu, b_cpu)}
        for what, hits in (("clean", []),) + CORRUPTIONS:
            seen = {}
            for where, guard in guards.items():
                prod = (clean if where == "cuda" else clean.cpu()).clone()
                for i, j, f in hits:
                    prod[i, j] += f * scale
                bb = b if where == "cuda" else b_cpu
                v = guard._verify(checks[where], bb, prod)
                fixed = guard._try_correct(prod, v)
                seen[where] = (v, None if fixed is None
                               else float(fixed[v.row, v.col]))
            (vg, fg), (vc, fc) = seen["cuda"], seen["cpu"]
            key = lambda v: (v.ok, v.bad_rows, v.bad_cols, v.row, v.col)  # noqa: E731
            if key(vg) != key(vc) or (fg is None) != (fc is None):
                fail(f"abft verdict {what} at ({k}, {n}): card {key(vg)} "
                     f"corrected={fg is not None}, CPU {key(vc)} "
                     f"corrected={fc is not None}")
            corr_err = None
            if fg is not None:
                want = float(clean[vg.row, vg.col])
                corr_err = max(abs(fg - want), abs(fc - want))
                if corr_err > TOL_ABFT * float(
                        a.to(torch.float64).abs().sum() * b.to(
                            torch.float64).abs().max()):
                    fail(f"abft verdict {what}: corrected element {fg} / {fc}"
                         f", clean {want}")
            expect_ok = not hits
            if vg.ok != expect_ok or (what == "one element") != (
                    fg is not None):
                fail(f"abft verdict {what} at ({k}, {n}): ok={vg.ok}, "
                     f"corrected={fg is not None}")
            out.append({"K": k, "N": n, "b_transposed_view": transposed,
                        "corruption": what, "ok": vg.ok,
                        "bad_rows": vg.bad_rows, "bad_cols": vg.bad_cols,
                        "first_bad": [vg.row, vg.col],
                        "corrected": fg is not None,
                        "corrected_abs_err": corr_err,
                        "equal_to_cpu_plain_route": True})
    return out


def served_decode_ms(short, longer, picks):
    """Device ms a served decode step of each picked kernel, from two
    profiled runs of the same requests (``profile_serve``) that differ only
    in their decode steps: the difference of their totals over the
    difference of their decode steps.  None where either run has no device
    rows or their prefills differ."""
    if (short.get("picked_ms_per_model_step") is None
            or longer.get("picked_ms_per_model_step") is None):
        return None
    prefills = [r["model_steps"] - r["decode_steps"] for r in (short, longer)]
    extra = longer["decode_steps"] - short["decode_steps"]
    if prefills[0] != prefills[1] or extra <= 0:
        return None
    return {p: (longer["picked_ms_per_model_step"][p] * longer["model_steps"]
                - short["picked_ms_per_model_step"][p] * short["model_steps"])
            / extra for p in picks}


def guard_stats(run):
    """The guarded backend's telemetry of a launcher run, and its host ms a
    GEMM (``backend_callback_seconds``)."""
    be = run.engine.backend
    _, cb_s, cb_n = run.engine.obs.registry.histogram(
        "backend_callback_seconds", labels=("backend",)).snapshot(
            backend=be.name)
    return run.stats.backend_telemetry, 1e3 * cb_s / cb_n


def chaos_run(cfg, params, scenario, bursts):
    """The chaos campaign's engine-level script at full width, on the
    campaign's own engines and prompts (``silent_burst``: ``bitflip`` at
    nominal rails; ``watchdog_delay``: the calibrated rails of a patience-5
    hwloop session), three requests of four tokens on two slots, every rail
    collapsed to ``V_CRASH`` before each decode step in ``bursts``.  Not
    ``run_scenario``: that reports neither the rails nor the recalibrations
    of each burst, nor how far a stream parts at a tie."""
    import numpy as np
    from repro_torch.resilience import V_CRASH
    from repro_torch.resilience import chaos as chaos_mod
    ctx = chaos_mod._Campaign(lambda: (cfg, params))
    if scenario == "silent_burst":
        eng, guard = chaos_mod._guarded_engine(ctx, corruption="bitflip")
        session, prompts = None, chaos_mod._prompts(3, 0)
    else:
        eng, guard, session = chaos_mod._watchdog_engine(ctx)
        prompts = chaos_mod._prompts(3, 1)
    reqs = chaos_mod._submit_all(eng, prompts, 4)
    accel = guard.accel
    after, recal_at = [], []
    step = 0
    t0 = time.monotonic()
    while not eng.scheduler.drained():
        if step in bursts:
            accel.set_rails(np.full(accel.n_partitions, V_CRASH))
        before = session.recalibrations if session is not None else 0
        eng.step()
        if step in bursts:
            after.append(float(np.min(accel.rails)))
            if session is not None:
                recal_at.append(session.recalibrations - before)
        step += 1
    stats = eng.run_until_drained()
    wall = time.monotonic() - t0
    return types.SimpleNamespace(
        engine=eng, guard=guard, requests=reqs, stats=stats,
        rails_after_bursts=after, recal_in_burst_steps=recal_at,
        session=session, wall_s=wall, v_crash=V_CRASH)


def serve_guard(torch, cfg, mods, params, ref, counters, abft_mod):
    """phi4-mini-3.8b at full width through the launcher with ``--guard
    abft``: (a) on ``reference`` (every GEMM on B1, every GEMM's checks one
    abft_checksums launch and every verification one abft_verdict launch):
    no detection, tokens bit-equal to the unguarded run of the ``serve``
    phase; its model step, host ms a GEMM and profiled kernels a step beside
    unguarded runs of the same workload just before and after it, held to
    ``GUARD_LIMITS``, and the guard's two kernels' device ms a served decode
    step held to ``ABFT_STEP_LIMIT_MS`` (a figure not measured fails); (b) on the emulated array at the calibrated rails
    (``--hwloop --guard-policy fail_closed``): no detection, no flag, tokens
    equal to ``serve_hwloop``'s; (c) the reference's ``silent_burst``
    script; (d) its ``watchdog_delay`` script."""
    serve_mod = mods.serve
    abft, verdict = abft_mod.abft_checksums, abft_mod.abft_verdict
    per_step = 7 * cfg.n_layers + 1
    argv = ["--arch", ARCH, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--requests", str(REQUESTS), "--max-new", str(MAX_NEW), "--mixed",
            "--seed", str(SEED)]
    api = mods.model_api(cfg)
    ratios = {}

    def unguarded():
        r = serve_mod.run(serve_mod.parse_args(argv + ["--backend",
                                                       "reference"]), params)
        torch.cuda.synchronize()
        _, cb_s, cb_n = r.engine.obs.registry.histogram(
            "backend_callback_seconds", labels=("backend",)).snapshot(
                backend="reference")
        return 1e3 * r.wall_s / r.stats.model_steps, 1e3 * cb_s / cb_n

    # ---- warm-up, uncounted
    serve_mod.run(serve_mod.parse_args(
        ["--arch", ARCH, "--slots", "2", "--max-len", str(MAX_LEN),
         "--requests", "2", "--max-new", "2", "--backend", "reference",
         "--guard", "abft"]), params)
    torch.cuda.synchronize()
    before = unguarded()

    # ---- (a) the main path: counts set to 0 just before, read just after
    counters.zero()
    abft.launches = verdict.launches = 0
    run = serve_mod.run(serve_mod.parse_args(
        argv + ["--backend", "reference", "--guard", "abft"]), params)
    torch.cuda.synchronize()
    launches = dict(counters.read(), abft_checksums=abft.launches,
                    abft_verdict=verdict.launches)
    after = unguarded()
    stats = run.stats
    tel, host_ms = guard_stats(run)
    steps = stats.model_steps
    if stats.completed != REQUESTS or stats.truncated or stats.unserved:
        fail(f"serve_guard reference: {stats.completed} of {REQUESTS} "
             f"completed")
    if tel["guard_detected"] or tel["guard_uncorrected"] or tel["flags"]:
        fail(f"serve_guard reference: {tel['guard_detected']} detections, "
             f"{tel['guard_uncorrected']} uncorrected, {tel['flags']} flags "
             f"on clean B1 products")
    if not (tel["guard_checks"] == tel["calls"] == per_step * steps
            == launches["systolic_mac"] == launches["abft_checksums"]
            == launches["abft_verdict"]):
        fail(f"serve_guard reference: {tel['guard_checks']} checks, "
             f"{tel['calls']} GEMMs, {launches} launches, expected "
             f"{per_step} x {steps}")
    if [r.out_tokens for r in run.requests] != [
            r.out_tokens for r in ref.requests]:
        fail("serve_guard reference: tokens differ from the unguarded run")
    ratios["reference"] = run.engine.backend.max_clean_ratio
    picks = tuple(f"{k}_kernel" for k in ABFT_STEP_LIMIT_MS)
    profile = profile_serve(torch, serve_mod, params, "reference",
                            extra=["--guard", "abft"], pick=picks)
    profile_unguarded = profile_serve(torch, serve_mod, params, "reference")
    # the same requests with more decode steps: the guard's kernels in the
    # served decode steps alone, apart from the prefills (M = a prompt)
    longer = profile_serve(torch, serve_mod, params, "reference",
                           extra=["--guard", "abft"], pick=picks,
                           max_new=3 + PROFILE_DECODE_EXTRA)
    decode_ms = served_decode_ms(profile, longer, picks)
    step_ms = 1e3 * run.wall_s / steps
    unguarded_step = (before[0] + after[0]) / 2
    unguarded_host = (before[1] + after[1]) / 2
    def excess(key):
        g, u = profile.get(key), profile_unguarded.get(key)
        return None if g is None or u is None else g - u

    held = {"model_step_ratio": step_ms / unguarded_step,
            "host_ms_per_gemm_ratio": host_ms / unguarded_host,
            "launches_per_model_step_over_unguarded": excess(
                "launches_per_model_step")}
    limits = dict(GUARD_LIMITS)
    for name, limit in ABFT_STEP_LIMIT_MS.items():
        key = f"{name}_device_ms_per_decode_step"
        held[key] = None if decode_ms is None else decode_ms[f"{name}_kernel"]
        limits[key] = limit
    for key, limit in limits.items():
        # a figure the run could not measure fails as one over its limit
        if held[key] is None or held[key] > limit:
            fail(f"serve_guard reference: {key} {held[key]} (null: not "
                 f"measured) over its limit {limit}")
    guarded_ref = {
        "backend": "guarded[reference]", "completed": stats.completed,
        "model_steps": steps, "decode_steps": stats.decode_steps,
        "gemm_calls": tel["calls"], "guard_checks": tel["guard_checks"],
        "guard_detected": tel["guard_detected"],
        "kernel_launches": launches,
        "tokens_bit_equal_to_unguarded": True,
        "model_step_ms": step_ms,
        "unguarded_model_step_ms": unguarded_step,
        "unguarded_model_step_ms_before_after": [before[0], after[0]],
        "serve_phase_model_step_ms": ref.model_step_ms,
        "host_ms_per_gemm": host_ms,
        "unguarded_host_ms_per_gemm": unguarded_host,
        **held, "limits": limits,
        "kernels_and_copies_per_model_step_over_unguarded": excess(
            "kernels_per_model_step"),
        "max_clean_ratio": ratios["reference"],
        "profile": profile, "profile_unguarded": profile_unguarded,
        "profile_more_decode_steps": longer}

    # ---- (b) the emulated array at the calibrated rails, fail_closed
    counters.zero()
    abft.launches = verdict.launches = 0
    emu = serve_mod.run(serve_mod.parse_args(
        argv + ["--backend", "emulated", "--hwloop", "--guard", "abft",
                "--guard-policy", "fail_closed"]), params)
    torch.cuda.synchronize()
    e_launches = dict(counters.read(), abft_checksums=abft.launches,
                      abft_verdict=verdict.launches)
    e_tel, e_host_ms = guard_stats(emu)
    if e_tel["guard_detected"] or e_tel["flags"] or e_tel["silent"]:
        fail(f"serve_guard emulated: {e_tel['guard_detected']} detections, "
             f"{e_tel['flags']} flags, {e_tel['silent']} silent at the "
             f"calibrated rails")
    if not (e_launches["abft_checksums"] == e_tel["calls"]
            == e_launches["abft_verdict"] == e_tel["guard_checks"]):
        fail(f"serve_guard emulated: {e_launches} launches for "
             f"{e_tel['calls']} GEMMs, {e_tel['guard_checks']} checks")
    if [r.out_tokens for r in emu.requests] != [
            r.out_tokens for r in ref.emulated_requests]:
        fail("serve_guard emulated: tokens differ from serve_hwloop's "
             "unguarded emulated run")
    ratios["emulated"] = emu.engine.backend.max_clean_ratio
    e_step = 1e3 * emu.wall_s / emu.stats.model_steps
    guarded_emu = {
        "backend": "guarded[emulated]", "hwloop": True,
        "policy": "fail_closed", "completed": emu.stats.completed,
        "model_steps": emu.stats.model_steps, "gemm_calls": e_tel["calls"],
        "guard_checks": e_tel["guard_checks"],
        "guard_detected": e_tel["guard_detected"], "flags": e_tel["flags"],
        "kernel_launches": e_launches,
        "tokens_equal_to_serve_hwloop": True,
        "model_step_ms": e_step,
        "unguarded_model_step_ms": ref.emulated_step_ms,
        "model_step_ratio": e_step / ref.emulated_step_ms,
        "host_ms_per_gemm": e_host_ms,
        "unguarded_host_ms_per_gemm": ref.emulated_host_ms_per_gemm,
        "energy_per_token_j": e_tel["energy_per_token_j"],
        "max_clean_ratio": ratios["emulated"]}

    # ---- (c), (d): the chaos scripts, each beside its burst-free run
    def logits_of(backend):
        return lambda req, fed: logits_alone(
            torch, api, params, req.prompt, fed, backend, mods.use_backend,
            mods.get_backend, mods.ShapeConfig)

    scripts = {}
    for scenario, bursts in (("silent_burst", (1, 4)),
                             ("watchdog_delay", (2,))):
        clean = chaos_run(cfg, params, scenario, ())
        hit = chaos_run(cfg, params, scenario, bursts)
        t = hit.guard.total
        if (t.guard_detected < 1 or t.guard_heals < 1
                or t.guard_uncorrected):
            fail(f"serve_guard {scenario}: detected {t.guard_detected}, "
                 f"heals {t.guard_heals}, uncorrected {t.guard_uncorrected}")
        if not hit.stats.guard_step_events:
            fail(f"serve_guard {scenario}: no decode-step guard events")
        if not all(v > hit.v_crash for v in hit.rails_after_bursts):
            fail(f"serve_guard {scenario}: rails after the bursts "
                 f"{hit.rails_after_bursts}")
        if any(r.status != "completed" for r in hit.requests):
            fail(f"serve_guard {scenario}: {[r.status for r in hit.requests]}")
        if clean.guard.total.guard_detected:
            fail(f"serve_guard {scenario}: detections without a burst")
        parted, gap = tokens_up_to_ties(
            torch, hit.requests, clean.requests, logits_of("ideal"),
            f"serve_guard {scenario} against its burst-free run")
        row = {"bursts_before_steps": list(bursts),
               "requests": len(hit.requests), "slots": 2, "max_new": 4,
               "completed": hit.stats.completed,
               "guard_checks": t.guard_checks,
               "guard_detected": t.guard_detected,
               "guard_corrected": t.guard_corrected,
               "guard_retries": t.guard_retries,
               "guard_heals": t.guard_heals,
               "guard_uncorrected": t.guard_uncorrected,
               "guard_step_events": hit.stats.guard_step_events,
               "silent_macs": t.silent,
               "rails_min_after_bursts": hit.rails_after_bursts,
               "v_crash": hit.v_crash,
               "streams_exact": len(hit.requests) - parted,
               "worst_gap_at_parting": gap,
               "wall_s": hit.wall_s, "burst_free_wall_s": clean.wall_s}
        if scenario == "watchdog_delay":
            row["recalibrations"] = hit.session.recalibrations
            row["recalibrations_in_burst_steps"] = hit.recal_in_burst_steps
            if hit.session.recalibrations < 1 or not all(
                    hit.recal_in_burst_steps):
                fail(f"serve_guard watchdog_delay: recalibrations "
                     f"{hit.session.recalibrations}, in the burst steps "
                     f"{hit.recal_in_burst_steps}")
        ratios[scenario] = max(hit.guard.max_clean_ratio,
                               clean.guard.max_clean_ratio)
        scripts[scenario] = row
    return launches, {
        "arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "reference": guarded_ref, "emulated": guarded_emu, **scripts,
        "max_clean_residual_over_tolerance": max(ratios.values()),
        "max_clean_ratio_by_run": ratios, "tol": 1e-6}


def autoscale(torch, cfg, mods, params, tflow):
    """The closed loop at full width: the ladder written on the card by the
    flow CLI (``--points-out``, in-process) and held byte for byte against
    the CPU's characterization; then phi4-mini served through the launcher
    on the emulated array with ``--autoscale threshold`` from that file,
    beside ``--autoscale static`` (tokens bit-equal) and the same loop on a
    ladder of level 0 alone (rails held at nominal: J/token above)."""
    import numpy as np
    from repro_torch import railscale
    from repro_torch.flow.__main__ import main as flow_main
    serve_mod = mods.serve
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    card, cpu = out_dir / "points_card.json", out_dir / "points_cpu.json"
    t0 = time.monotonic()
    with contextlib.redirect_stdout(sys.stderr):
        rc = flow_main(["run", "--array-n", "8", "--tech", "vtr-22nm",
                        "--max-trials", "8", "--seed", "2021",
                        "--points-out", str(card)])
    cli_s = time.monotonic() - t0
    if rc != 0:
        fail(f"autoscale: flow --points-out exited {rc}")
    fcfg = tflow.FlowConfig(array_n=8, tech="vtr-22nm", max_trials=8,
                            seed=2021, algo="dbscan")
    report = tflow.run(fcfg)
    railscale.save_tables(str(cpu), [railscale.OperatingPointTable
                                     .characterize(report, fcfg,
                                                   seed=fcfg.seed,
                                                   device="cpu")])
    if card.read_bytes() != cpu.read_bytes():
        fail("autoscale: the ladder written on the card differs from the "
             "CPU's")
    table = railscale.OperatingPointTable.load(str(card))
    level0 = out_dir / "points_level0.json"
    railscale.save_tables(str(level0), [railscale.OperatingPointTable(
        [table[0]], meta=table.meta)])

    # per decode step: the level in force and the ledger's energy and
    # tokens, read where the engine ticks the autoscaler
    record = []
    tick = railscale.Autoscaler.on_decode_step

    def recording_tick(self):
        eng = self._engine
        record.append((self.level, eng.backend.accel.ledger.total_j,
                       eng.stats.tokens_generated))
        tick(self)

    argv = ["--arch", ARCH, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--requests", str(SLOTS), "--max-new", str(AUTOSCALE_NEW),
            "--seed", str(SEED), "--backend", "emulated",
            "--autoscale-every", "1"]
    trace = out_dir / "autoscale_trace.ndjson"
    runs = {}
    railscale.Autoscaler.on_decode_step = recording_tick
    try:
        for what, extra in (
                ("threshold", ["--autoscale", "threshold",
                               "--autoscale-points", str(card),
                               "--trace-out", str(trace)]),
                ("static", ["--autoscale", "static"]),
                ("level 0 held", ["--autoscale", "threshold",
                                  "--autoscale-points", str(level0)])):
            record.clear()
            with contextlib.redirect_stdout(sys.stderr):
                run = serve_mod.run(serve_mod.parse_args(argv + extra),
                                    params)
                if "--trace-out" in extra:
                    run.engine.obs.close_trace()
            torch.cuda.synchronize()
            runs[what] = (run, list(record))
    finally:
        railscale.Autoscaler.on_decode_step = tick
    run, rec = runs["threshold"]
    stats, tel, rs = run.stats, run.stats.backend_telemetry, \
        run.stats.railscale
    decisions = sum(1 for line in trace.read_text().splitlines()
                    if json.loads(line).get("name") == "railscale_decision")
    if rs["level"] <= 0 or rs["transitions"]["down"] < 2:
        fail(f"autoscale: level {rs['level']}, transitions "
             f"{rs['transitions']}")
    if decisions != rs["decisions"]:
        fail(f"autoscale: {decisions} railscale_decision events for "
             f"{rs['decisions']} decisions")
    if tel["flags"] or tel["silent"] or any(
            any(f) for f in stats.backend_step_flags):
        fail(f"autoscale: {tel['flags']} flags, {tel['silent']} silent on "
             f"the ladder")
    static, held = runs["static"][0], runs["level 0 held"][0]
    if [r.out_tokens for r in run.requests] != [
            r.out_tokens for r in static.requests]:
        fail("autoscale: tokens differ from the --autoscale static run")
    e_auto = tel["energy_per_token_j"]
    e_held = held.stats.backend_telemetry["energy_per_token_j"]
    if not e_auto < e_held:
        fail(f"autoscale: {e_auto} J/token against {e_held} with the rails "
             f"held at level 0")
    by_level = {}
    for (lv, e0, n0), (_, e1, n1) in zip(rec, rec[1:] + [
            (None, run.engine.backend.accel.ledger.total_j,
             stats.tokens_generated)]):
        acc = by_level.setdefault(lv, [0.0, 0])
        acc[0] += e1 - e0
        acc[1] += n1 - n0
    return {"arch": ARCH, "slots": SLOTS, "requests": SLOTS,
            "max_new": AUTOSCALE_NEW, "decide_every": 1,
            "ladder": table.to_dict(), "ladder_cli_seconds_on_card": cli_s,
            "ladder_bytes_equal_to_cpu": True,
            "policy": rs["policy"], "level": rs["level"],
            "levels": rs["levels"], "decisions": rs["decisions"],
            "decision_events": decisions,
            "transitions": rs["transitions"],
            "heal_preemptions": rs["heal_preemptions"],
            "rails_v": rs["rails_v"], "flags": tel["flags"],
            "decode_steps": stats.decode_steps,
            "tokens_bit_equal_to_static": True,
            "energy_per_token_j": e_auto,
            "static_energy_per_token_j":
                static.stats.backend_telemetry["energy_per_token_j"],
            "level0_held_energy_per_token_j": e_held,
            "served_j_per_token_by_level": {
                str(lv): (e / n if n else None)
                for lv, (e, n) in sorted(by_level.items())},
            "model_step_ms": 1e3 * run.wall_s / stats.model_steps,
            "static_model_step_ms":
                1e3 * static.wall_s / static.stats.model_steps}


# ---------------------------------------------------------------------------
# server/ and resilience/chaos.py: HTTP serving, trace replay, the campaign
# ---------------------------------------------------------------------------


def prometheus_samples(text):
    """The samples of a Prometheus text exposition, or fail on a line that
    does not parse."""
    samples = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            samples[name] = float(value)
        except ValueError:
            fail(f"serve_http: /metrics line {line!r} does not parse")
    return samples


def decode_step_ms(engine):
    """Mean milliseconds of an engine's ``decode_step`` spans (its flight
    recorder; a span ends after the step's tokens reached the host)."""
    durs = [e["dur_s"] for e in engine.obs.recorder.to_list()
            if e.get("name") == "decode_step"]
    return 1e3 * sum(durs) / len(durs)


def read_line(stream, timeout_s):
    """One line of a child's pipe, or "" after ``timeout_s``."""
    import threading
    got = []
    t = threading.Thread(target=lambda: got.append(stream.readline()),
                         daemon=True)
    t.start()
    t.join(timeout_s)
    return got[0] if got else ""


def launcher_http(ref, flags):
    """``python -m repro_torch.launch.serve --serve-http 127.0.0.1:0`` at
    full width as a child process, with ``serve_http``'s engine flags: read
    the bound address, stream one warm-up request, then the ``serve``
    phase's six requests at once from this process, send SIGINT, and
    require every stream equal to the ``serve`` phase's, the
    ``drained=True`` line and exit code 0.  The child's decode steps after
    the warm-up, from its ``--trace-out`` spans, are the server's with the
    clients in another process."""
    import asyncio
    import os
    import signal
    from repro_torch.server import get_json, stream_generate
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    spans = out_dir / "launcher_http_spans.ndjson"
    spans.unlink(missing_ok=True)
    reqs = ref.requests
    warm_new = min(2, reqs[0].max_new_tokens)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *flags,
           "--serve-http", "127.0.0.1:0", "--trace-out", str(spans)]

    async def clients(host, port):
        warm = await stream_generate(host, port, reqs[0].prompt,
                                     max_new_tokens=warm_new)
        health = await get_json(host, port, "/healthz")
        t0 = time.monotonic()
        results = await asyncio.gather(*[stream_generate(
            host, port, r.prompt, max_new_tokens=r.max_new_tokens)
            for r in reqs])
        return warm, health["decode_steps"], results, time.monotonic() - t0

    t0 = time.monotonic()
    with open(out_dir / "launcher_http.err", "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=err, text=True,
                                env={**os.environ, "PYTHONPATH": str(SRC)})
        try:
            first = read_line(proc.stdout, 300)
            if not first.startswith("serving on http://"):
                fail(f"serve_http launcher: first line {first!r}, exit "
                     f"{proc.poll()}")
            ready_s = time.monotonic() - t0
            host, port = first.split("http://")[1].split()[0].rsplit(":", 1)
            warm, warm_steps, results, wall = asyncio.run(
                clients(host, int(port)))
            proc.send_signal(signal.SIGINT)
            out, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    tail = (out_dir / "launcher_http.err").read_text()[-2000:]
    if proc.returncode != 0 or "drained=True" not in out:
        fail(f"serve_http launcher: exit {proc.returncode}, stdout {out!r}, "
             f"stderr {tail!r}")
    for i, (res, r) in enumerate(zip([warm] + results,
                                     [reqs[0]] + list(reqs))):
        want = r.out_tokens[:warm_new] if i == 0 else r.out_tokens
        if not (res.ok and res.status == "completed"):
            fail(f"serve_http launcher: stream {i} {res.http_status} "
                 f"{res.summary}")
        if res.tokens != want:
            fail(f"serve_http launcher: stream {i} tokens {res.tokens} "
                 f"differ from the serve phase's {want} (seed {SEED} "
                 f"params)")
    durs = [e["dur_s"] for e in map(json.loads,
                                    spans.read_text().splitlines())
            if e.get("name") == "decode_step" and e["step"] >= warm_steps]
    if not durs:
        fail("serve_http launcher: no decode_step span after the warm-up")
    tokens = sum(len(res.tokens) for res in results)
    return {"command": " ".join(cmd[1:-2]), "ready_s": ready_s,
            "tokens_equal_to_serve": True, "exit_code": proc.returncode,
            "drained_line": next(line for line in out.splitlines()
                                 if line.startswith("drained=")),
            "decode_step_ms": 1e3 * sum(durs) / len(durs),
            "decode_steps_timed": len(durs),
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "seconds": time.monotonic() - t0}


def serve_http(torch, cfg, mods, params, ref, systolic_mac):
    """phi4-mini-3.8b at full width behind the port's HTTP frontend: a
    ``reference`` engine (slots 4, max_len 64, ``--policy priority
    --max-pending 8``) driven by the frontend's pump thread, the ``serve``
    phase's six requests sent at once through ``stream_generate``, and
    ``/healthz``, ``/metrics`` and ``/v1/stats`` scraped while they stream.
    Every stream is bit-equal to the ``serve`` phase's tokens for the same
    request (B1 sums in an order fixed by (K, N, dtype), never by M or the
    rows beside a row), and B1's launches equal the engine's GEMMs.  The
    same engine flags driven directly give the tokens/s beside it."""
    import asyncio
    import threading
    import numpy as np
    from repro_torch.server import ServeFrontend, get_json, stream_generate
    from repro_torch.server.client import _request
    serve_mod = mods.serve
    per_step = 7 * cfg.n_layers + 1
    argv = ["--arch", ARCH, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--backend", "reference", "--policy", "priority",
            "--max-pending", str(HTTP_MAX_PENDING)]
    reqs = ref.requests

    def frontend_run(requests):
        engine = serve_mod.build_engine(serve_mod.parse_args(argv), params)
        frontend = ServeFrontend(engine)
        seen = {}

        async def scenario():
            host, port = await frontend.start()
            t0 = time.monotonic()
            streams = [asyncio.create_task(stream_generate(
                host, port, r.prompt, max_new_tokens=r.max_new_tokens))
                for r in requests]
            while not all(t.done() for t in streams):
                health = await get_json(host, port, "/healthz")
                if health["active"] > 0:
                    seen["health"] = health
                    _, _, text = await _request(host, port, "GET",
                                                "/metrics")
                    seen["metrics"] = text.decode()
                    seen["stats"] = await get_json(host, port, "/v1/stats")
                    seen["active_after"] = sum(not t.done() for t in streams)
                    break
                await asyncio.sleep(0.002)
            results = await asyncio.gather(*streams)
            wall = time.monotonic() - t0
            seen["pump_alive"] = frontend.health()["pump_alive"]
            seen["drained"] = await frontend.drain()
            await frontend.close()
            return results, wall

        results, wall = asyncio.run(scenario())
        torch.cuda.synchronize()
        return engine, results, wall, seen

    # ---- warm-up, uncounted: the pump thread's first launches
    frontend_run(reqs[:2])

    # ---- beside it: the same engine flags, driven directly, on this
    # thread and on a thread of its own with no event loop beside it
    direct_argv = argv + ["--requests", str(REQUESTS), "--max-new",
                          str(MAX_NEW), "--mixed", "--seed", str(SEED)]
    direct = serve_mod.run(serve_mod.parse_args(direct_argv), params)
    torch.cuda.synchronize()
    threaded = []

    def on_thread():
        torch.cuda.set_device(torch.device("cuda", 0))
        threaded.append(serve_mod.run(serve_mod.parse_args(direct_argv),
                                      params))

    worker = threading.Thread(target=on_thread)
    worker.start()
    worker.join()
    if len(threaded) != 1:
        fail("serve_http: the run on a thread of its own did not finish")
    for what, run in (("direct", direct), ("threaded", threaded[0])):
        if [r.out_tokens for r in run.requests] != [r.out_tokens
                                                    for r in reqs]:
            fail(f"serve_http: the {what} run's tokens differ from the "
                 f"serve phase's")

    # ---- the path: counts set to 0 just before, read just after
    systolic_mac.launches = 0
    engine, results, wall, seen = frontend_run(reqs)
    launches = systolic_mac.launches
    stats = engine.run_until_drained()
    tel = stats.backend_telemetry
    steps = stats.model_steps
    for i, (res, r) in enumerate(zip(results, reqs)):
        if not (res.ok and res.status == "completed"):
            fail(f"serve_http: stream {i} ended {res.status}/"
                 f"{res.http_status}: {res.summary}")
        if res.tokens != r.out_tokens:
            fail(f"serve_http: stream {i} tokens {res.tokens} differ from "
                 f"the serve phase's {r.out_tokens}")
    if not (0 < launches == tel["calls"] == per_step * steps):
        fail(f"serve_http: {launches} systolic_mac launches, {tel['calls']} "
             f"GEMMs, expected {per_step} x {steps} model steps")
    if not (seen.get("pump_alive") and seen.get("drained")):
        fail(f"serve_http: pump_alive {seen.get('pump_alive')}, drained "
             f"{seen.get('drained')}")
    if "health" not in seen:
        fail("serve_http: no scrape saw a live stream")
    samples = prometheus_samples(seen["metrics"])
    stats_json = seen["stats"]
    if not (seen["health"]["_http_status"] == 200 == stats_json[
            "_http_status"] and {"health", "engine", "metrics"}
            <= set(stats_json) and samples.get("serve_slots") == SLOTS):
        fail(f"serve_http: scrapes {seen['health']}, "
             f"{sorted(stats_json)}, {len(samples)} samples")
    ttft = np.asarray([res.summary["ttft_s"] for res in results])
    tokens = sum(len(res.tokens) for res in results)
    return {
        "arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "backend": "reference", "slots": SLOTS, "max_len": MAX_LEN,
        "policy": "priority", "max_pending": HTTP_MAX_PENDING,
        "requests": len(reqs), "completed": stats.completed,
        "prefill_steps": stats.prefill_steps,
        "decode_steps": stats.decode_steps, "gemm_calls": tel["calls"],
        "kernel_launches": launches,
        "tokens_bit_equal_to_serve": True,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "direct_tokens_per_s": direct.stats.tokens_generated / direct.wall_s,
        "direct_model_step_ms": 1e3 * direct.wall_s
        / direct.stats.model_steps,
        "model_step_ms": 1e3 * wall / steps,
        "serve_model_step_ms": ref.model_step_ms,
        "decode_step_ms": decode_step_ms(engine),
        "direct_decode_step_ms": decode_step_ms(direct.engine),
        "threaded_decode_step_ms": decode_step_ms(threaded[0].engine),
        "decode_step_of": "mean decode_step span of the HTTP run (the "
                          "pump thread, the event loop and the clients in "
                          "this process), the same flags driven directly, "
                          "and driven on a thread of its own; the "
                          "launcher's is the --serve-http child's, its "
                          "clients in this process",
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "ttft_of": "the engine's submit-to-first-token seconds of each "
                   "HTTP request (stream summary)",
        "scrape": {"active_slots": seen["health"]["active"],
                   "streams_live": seen["active_after"],
                   "metrics_samples": len(samples),
                   "stats_keys": sorted(stats_json)},
        "launcher": launcher_http(ref, argv)}


def serve_trace(torch, cfg, mods, systolic_mac):
    """A traffic trace written by the port's CLI (``python -m
    repro_torch.server``) at 1.5x the deployment's capacity and replayed
    through ``launch.serve --trace`` at full width on the card; every
    ``TrafficMetrics`` field but ``wall_s`` equals the same replay on the
    CPU at phi4-mini's smoke config (the schedule depends on the trace and
    the scheduler only: no stop token)."""
    import os
    from repro_torch.server import TrafficConfig, overload_rate_rps
    serve_mod = mods.serve
    per_step = 7 * cfg.n_layers + 1
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = out_dir / "trace.ndjson"
    rate = overload_rate_rps(TRACE_OVERLOAD, SLOTS, TRACE_STEP_COST,
                             TrafficConfig())
    t0 = time.monotonic()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.server", "--out", str(trace),
         "--rate", repr(rate), "--duration", str(TRACE_DURATION), "--seed",
         str(SEED)], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    cli_s = time.monotonic() - t0
    if done.returncode != 0:
        fail(f"serve_trace: the trace CLI exited {done.returncode}: "
             f"{done.stderr[-2000:]}")
    flags = ["--arch", ARCH, "--backend", "reference", "--trace", str(trace),
             "--slots", str(SLOTS), "--max-len", str(MAX_LEN), "--policy",
             "priority", "--max-pending", str(HTTP_MAX_PENDING),
             "--step-cost", str(TRACE_STEP_COST)]
    card_json = out_dir / "trace_card.json"
    cpu_json = out_dir / "trace_cpu.json"
    systolic_mac.launches = 0
    with contextlib.redirect_stdout(sys.stderr):
        serve_mod.main(flags + ["--json-out", str(card_json)])
    torch.cuda.synchronize()
    launches = systolic_mac.launches
    t0 = time.monotonic()
    with contextlib.redirect_stdout(sys.stderr):
        serve_mod.main(flags + ["--smoke", "--device", "cpu", "--json-out",
                                str(cpu_json)])
    cpu_s = time.monotonic() - t0
    card = json.loads(card_json.read_text())
    cpu = json.loads(cpu_json.read_text())
    differ = {k: (card.get(k), cpu.get(k)) for k in set(card) | set(cpu)
              if k != "wall_s" and card.get(k) != cpu.get(k)}
    if list(card) != list(cpu) or differ:
        fail(f"serve_trace: the card's replay differs from the CPU's: "
             f"{differ}")
    if not (0 < launches == per_step * card["model_steps"]):
        fail(f"serve_trace: {launches} systolic_mac launches for "
             f"{card['model_steps']} model steps of {per_step} GEMMs")
    return {"arch": ARCH, "rate_rps": rate, "overload": TRACE_OVERLOAD,
            "duration_s": TRACE_DURATION, "step_cost_s": TRACE_STEP_COST,
            "trace_cli_s": cli_s, "metrics": card,
            "metrics_equal_to_cpu_but_wall_s": True, "cpu_wall_s":
            cpu["wall_s"], "cpu_replay_s": cpu_s,
            "kernel_launches": launches,
            "real_tokens_per_s": card["tokens_generated"] / card["wall_s"],
            "model_step_ms": 1e3 * card["wall_s"] / card["model_steps"]}


def chaos(torch, cfg, params, abft_mod):
    """The port's chaos campaign's four wire scenarios on the card, phi4-mini
    at full width on a guarded emulated engine (every verification on
    ``abft_checksums`` and ``abft_verdict``); each completed stream is held
    to the same engine's fault-free run.  The scenarios run one
    ``run_scenario`` call each, as ``run_campaign`` runs them, so that each
    is timed."""
    from repro_torch.resilience import run_scenario
    abft, verdict = abft_mod.abft_checksums, abft_mod.abft_verdict
    abft.launches = verdict.launches = 0
    rows = {}
    t0 = time.monotonic()
    for name in CHAOS_SCENARIOS:
        t1 = time.monotonic()
        r = run_scenario(name, fast=True, model=lambda: (cfg, params),
                         truth="fault_free")
        rows[name] = {"ok": r.ok, "violations": r.violations,
                      "wall_s": time.monotonic() - t1, **r.details}
    elapsed = time.monotonic() - t0
    torch.cuda.synchronize()
    launches, v_launches = abft.launches, verdict.launches
    if not all(r["ok"] and not r.get("crashed") for r in rows.values()):
        print(json.dumps({"chaos_red": rows})[-20000:], file=sys.stderr)
        fail(f"chaos: {[(n, r['violations']) for n, r in rows.items()]}")
    if launches <= 0 or v_launches <= 0:
        fail("chaos: the guarded engines launched abft_checksums or "
             "abft_verdict no time")
    return {"arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "fast": True, "truth": "fault_free", "scenarios": rows,
            "abft_verdict_launches": v_launches,
            "elapsed_s": elapsed, "abft_checksums_launches": launches}


# ---------------------------------------------------------------------------
# wkv6 and ssd_chunk (models/ssm.py: rwkv6-1.6b, zamba2-2.7b)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the dispatch census (repro_torch.analysis) on the card
# ---------------------------------------------------------------------------


def census_phase(torch, cfg, mods, params):
    """``repro_torch.analysis.census`` on the card: every config of its
    CENSUS_ARCHS on ``reference`` and ``ideal``, whose routed GEMMs, dots
    and kernel calls must equal the CPU's pins (``census_baseline_torch.json``);
    each call's host synchronisations, which only the card shows whole.
    Then phi4-mini-3.8b at full width (the serve phase's weights) on
    ``reference``: one prefill, one ``decode_step`` and one ``ServeEngine``
    decode step, each with 7 L + 1 = 225 routed GEMMs a decode step, equal to
    B1's launches, and its host synchronisations by op and frame: the
    worklist of a CUDA-graph capture of the served step."""
    from repro_torch.analysis import census as census_mod
    from repro_torch.serve import Request
    t0 = time.monotonic()
    pins = json.loads((ROOT / CENSUS_BASELINE).read_text())
    report = census_mod.census(device=DEVICE)
    smoke = {}
    for be, run in pins["backends"].items():
        for arch, pinned in run["configs"].items():
            for phase in ("prefill", "decode"):
                pin = pinned[phase]
                cur = report["backends"][be]["configs"][arch][phase]
                where = f"census {be}/{arch}.{phase}"
                if (pin is None) != (cur is None):
                    fail(f"{where}: present on the card {cur is not None}, "
                         f"pinned {pin is not None}")
                if pin is None:
                    continue
                for key in census_mod.PINNED:
                    if cur[key] != pin[key]:
                        fail(f"{where}: {key} {cur[key]} on the card, "
                             f"{pin[key]} pinned on the CPU")
                smoke[f"{be}/{arch}.{phase}"] = {
                    "host_syncs": cur["host_syncs"],
                    "host_sync_sites": cur["host_sync_sites"],
                    "host_syncs_cpu_pin": pin["host_syncs"]}
    smoke_s = time.monotonic() - t0

    per_step = 7 * cfg.n_layers + 1
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 20)
    be = mods.get_backend("reference")
    api = mods.model_api(cfg, backend=be)
    prompt = torch.randint(3, cfg.vocab_size, (1, CENSUS_PROMPT),
                           generator=gen, device=DEVICE)
    toks = torch.randint(3, cfg.vocab_size, (SLOTS, 1), generator=gen,
                         device=DEVICE)
    state = api.make_decode_state(mods.ShapeConfig("census", MAX_LEN, SLOTS,
                                                   "decode"))
    calls = {
        "prefill": census_mod.count_call(
            lambda: api.prefill(params, {"tokens": prompt},
                                max_len=MAX_LEN), be),
        "decode_step": census_mod.count_call(
            lambda: api.decode_step(params, state, toks), be)}
    engine = mods.ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                              backend="reference")
    for uid in range(SLOTS):
        engine.submit(Request(uid=uid, prompt=prompt[0, :4 + uid].tolist(),
                              max_new_tokens=MAX_NEW))
    engine.step()               # admissions, prefills, the first decode step
    calls["engine_step"] = census_mod.count_call(engine.step, engine.backend)
    if calls["prefill"]["backend_gemms"] != per_step:
        fail(f"census phi4 prefill: {calls['prefill']['backend_gemms']} "
             f"routed GEMMs, expected {per_step}")
    for name in ("decode_step", "engine_step"):
        c = calls[name]
        if not (c["backend_gemms"] == per_step
                == c["kernel_calls"].get("systolic_mac")):
            fail(f"census phi4 {name}: {c['backend_gemms']} routed GEMMs, "
                 f"{c['kernel_calls']} kernel calls, expected {per_step}")
    for name, c in calls.items():
        print(f"census {ARCH} {name}: {c['backend_gemms']} routed GEMMs, "
              f"{c['dots']} dots, {c['host_syncs']} host syncs "
              f"{[(x['site'], x['count']) for x in c['host_sync_sites']]}",
              flush=True)
    return {"configs": smoke, "configs_equal_to_cpu_pins": True,
            "configs_seconds": smoke_s,
            "phi4": {"arch": ARCH, "backend": "reference", "slots": SLOTS,
                     "prompt": CENSUS_PROMPT, "gemms_per_decode_step":
                     per_step, **calls},
            "seconds": time.monotonic() - t0}


@contextlib.contextmanager
def recording_calls(cls, name, record):
    """``cls.name`` calls ``record(self, *args)`` first while the block
    runs."""
    orig = getattr(cls, name)

    def wrapped(self, *args, **kw):
        record(self, *args)
        return orig(self, *args, **kw)
    setattr(cls, name, wrapped)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def examples_phase(torch, cfg, params, systolic_mac, tflow, device=DEVICE):
    """The port's examples (``repro_torch.examples``) through their
    ``run()``: quickstart's flow and sweep; serve_batched, hwloop_serve
    (emulated and probe) and traffic_overload (``reference``: every model
    GEMM one ``systolic_mac`` launch) on phi4-mini-3.8b at full width on the
    serve phase's weights; train_lm at its full ~100M-parameter size.
    Returns B1's launches in traffic_overload and the phase's record."""
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.examples import (hwloop_serve, quickstart, serve_batched,
                                      traffic_overload, train_lm)
    from repro_torch.hwloop.device import EmulatedAccelerator
    from repro_torch.roofline.analytic import forward_flops
    t_phase = time.monotonic()
    per_step = 7 * cfg.n_layers + 1
    out = {}

    # ---- quickstart: the flow, the timing report and the 2 x 2 sweep
    t0 = time.monotonic()
    q = quickstart.run()
    direct = tflow.run(q.cfg)
    runs, n_cfgs = q.result.timing_stage_runs(), len(q.result.configs)
    if (runs, n_cfgs) != (2, 4):
        fail(f"examples quickstart: the timing stage ran {runs}x for "
             f"{n_cfgs} configs, expected 2x for 4")
    for key in ("static_v", "runtime_v", "razor_trials", "baseline_mw",
                "static_mw", "runtime_mw"):
        if not np.array_equal(getattr(q.report, key), getattr(direct, key)):
            fail(f"examples quickstart: {key} {getattr(q.report, key)} "
                 f"beside {getattr(direct, key)} from flow.run")
    out["quickstart"] = {
        "stages": q.stages, "timing_stage_runs": runs, "configs": n_cfgs,
        "static_v": q.report.static_v.tolist(),
        "runtime_v": q.report.runtime_v.tolist(),
        "razor_trials": q.report.razor_trials,
        "mw": [q.report.baseline_mw, q.report.static_mw,
               q.report.runtime_mw],
        "equal_to_flow_run": True, "seconds": time.monotonic() - t0}

    # ---- serve_batched: ideal serving and the power model of the session
    t0 = time.monotonic()
    sb = serve_batched.run(cfg, params, device=device)
    stats = sb.stats
    for r in sb.reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab for t in r.out_tokens):
            fail(f"examples serve_batched: request {r.uid} produced "
                 f"{r.out_tokens}")
    macs = forward_flops(cfg, ShapeConfig("serve", serve_batched.MAX_LEN, 1,
                                          "decode")) / 2 * (
        sum(len(r.prompt) for r in sb.reqs)
        + serve_batched.SLOTS * stats.decode_steps)
    if stats.completed != len(sb.reqs) or sb.macs != macs:
        fail(f"examples serve_batched: {stats.completed} of {len(sb.reqs)} "
             f"completed, {sb.macs} MACs beside the power model's {macs}")
    if not 0 < sb.tuned < sb.base:
        fail(f"examples serve_batched: {sb.tuned} J on the calibrated "
             f"islands, {sb.base} J at nominal rails")
    out["serve_batched"] = {
        "arch": ARCH, "requests": len(sb.reqs),
        "tokens_generated": stats.tokens_generated,
        "prefill_steps": stats.prefill_steps,
        "decode_steps": stats.decode_steps, "serve_s": sb.seconds,
        "macs": sb.macs, "nominal_mj": 1e3 * sb.base,
        "calibrated_mj": 1e3 * sb.tuned, "seconds": time.monotonic() - t0}

    # ---- hwloop_serve: the undervolt healed on both backends
    out["hwloop_serve"] = {}
    for backend in hwloop_serve.BACKENDS:
        t0 = time.monotonic()
        shapes = []
        with recording_calls(EmulatedAccelerator, "matmul",
                             lambda self, a, w: shapes.append(
                                 (a.shape[0], a.shape[1], w.shape[1]))):
            h = hwloop_serve.run(cfg, params, backend, device=device)
        calibrated, undervolted = h.batches
        where = f"examples hwloop_serve {backend}"
        if any(any(f) for f in calibrated.stats.hwloop_step_flags):
            fail(f"{where}: the calibrated batch flagged "
                 f"{calibrated.stats.hwloop_step_flags}")
        if undervolted.stats.hwloop["recalibrations"] < 1:
            fail(f"{where}: the undervolted batch made no recalibration")
        if not h.healed_rails[0] > h.undervolt_v:
            fail(f"{where}: healed rail 0 {h.healed_rails[0]} V, undervolt "
                 f"{h.undervolt_v} V")
        row = {"calibrated_rails": h.calibrated_rails.tolist(),
               "v_safe": h.v_safe, "undervolt_v": h.undervolt_v,
               "healed_rails": h.healed_rails.tolist(),
               "batches": [{"tag": b.tag, "line": b.line,
                            "tokens_generated": b.stats.tokens_generated,
                            "model_steps": b.stats.model_steps,
                            "hwloop": b.stats.hwloop} for b in h.batches]}
        if backend == "emulated":
            bt = undervolted.stats.backend_telemetry   # both batches'
            steps = sum(b.stats.model_steps for b in h.batches)
            mkn = sum(m * k * n for m, k, n in shapes)
            if calibrated.stats.backend_telemetry["flags"] != 0:
                fail(f"{where}: the calibrated batch raised "
                     f"{calibrated.stats.backend_telemetry['flags']} flags")
            if not bt["calls"] == len(shapes) == per_step * steps:
                fail(f"{where}: {bt['calls']} backend GEMMs, {len(shapes)} "
                     f"on the array, {per_step} x {steps} model steps")
            if bt["macs"] != mkn:
                fail(f"{where}: {bt['macs']} MACs, the GEMMs' M x K x N sum "
                     f"to {mkn}")
            row.update(gemms=bt["calls"], macs=bt["macs"], flags=bt["flags"],
                       emulated_model_step_ms=None if not steps else
                       1e3 * (time.monotonic() - t0) / steps)
        row["seconds"] = time.monotonic() - t0
        out["hwloop_serve"][backend] = row

    # ---- traffic_overload on reference: counts set to 0 just before
    t0 = time.monotonic()
    systolic_mac.launches = 0
    t = traffic_overload.run(cfg, params, "reference", device=device)
    torch.cuda.synchronize()
    launches = systolic_mac.launches
    bt = t.backend_telemetry
    if not t.drained:
        fail("examples traffic_overload: the frontend did not drain")
    for tier, split in t.by_tier.items():
        n = sum(ev.priority.name == tier for ev in t.events)
        if split["completed"] + split["shed"] != n:
            fail(f"examples traffic_overload: tier {tier} {split} of {n} "
                 f"events")
    if not (launches == bt["calls"] > 0 and bt["flags"] == 0):
        fail(f"examples traffic_overload: {launches} systolic_mac launches "
             f"for {bt['calls']} backend GEMMs, {bt['flags']} flags")
    out["traffic_overload"] = {
        "arch": ARCH, "backend": "reference", "events": len(t.events),
        "by_tier": t.by_tier, "drained": t.drained,
        "ttft_p50_ms": t.p50_ms, "ttft_p99_ms": t.p99_ms,
        "slo_met": t.slo_met, "slo": t.slo,
        "shed_rate": t.health["shed_rate"],
        "tokens_generated": t.health["tokens_generated"],
        "wall_s": t.wall_s, "gemms": bt["calls"],
        "systolic_mac_launches": launches, "flags": bt["flags"],
        "seconds": time.monotonic() - t0}

    # ---- train_lm at its full size; every checkpoint save counted
    t0 = time.monotonic()
    kw = EXAMPLES_TRAIN_LM
    shutil.rmtree(EXAMPLES_CHECKPOINT_DIR, ignore_errors=True)
    saves = []
    held_gb = torch.cuda.memory_allocated() / 1e9     # phi4's weights
    torch.cuda.reset_peak_memory_stats()
    with recording_calls(CheckpointManager, "save",
                         lambda self, step, *rest: saves.append(step)):
        tl = train_lm.run(train_lm.lm_config(kw["d_model"], kw["layers"]),
                          kw["steps"], kw["batch"], kw["seq"],
                          str(EXAMPLES_CHECKPOINT_DIR), device=device)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = tl.res.losses
    kept = CheckpointManager(EXAMPLES_CHECKPOINT_DIR).all_steps()
    if not (tl.res.steps_done == kw["steps"] and losses[-1] < losses[0]):
        fail(f"examples train_lm: {tl.res.steps_done} steps, loss "
             f"{losses[0]} -> {losses[-1]}")
    every = max(kw["steps"] // 4, 1)
    want = list(range(every, kw["steps"] + 1, every))
    if saves != want or kept != want[-len(kept):] or not kept:
        fail(f"examples train_lm: checkpoints saved at {saves}, kept "
             f"{kept}, expected saves at {want}")
    out["train_lm"] = {
        **kw, "n_params": tl.n_params, "loss_first": losses[0],
        "loss_last": losses[-1], "steps_done": tl.res.steps_done,
        "train_s": tl.res.wall_s, "step_s": tl.res.wall_s / kw["steps"],
        "peak_device_memory_gb": peak_gb,
        "device_memory_held_before_gb": held_gb, "checkpoints_saved": saves,
        "checkpoints_kept": kept, "seconds": time.monotonic() - t0}
    shutil.rmtree(EXAMPLES_CHECKPOINT_DIR, ignore_errors=True)

    out["seconds"] = time.monotonic() - t_phase
    out["budget_s"] = EXAMPLES_BUDGET_S
    return launches, out


def wkv6_bound_ms(b, s, h, p, chunk):
    """Least time for one wkv6 call: r, k, v, w read once, y written once,
    u read once, the state read and written once; per chunk and head the
    products the function needs: the score tile's strictly lower ch (ch - 1)
    / 2 entries (p multiply-adds each) and their product with v (the same
    count), and the carried state's term and the state update (ch p p
    each), so 2 ch (ch - 1) p + 4 ch p p operations, on the TF32 tensor
    cores the three passes use, TF32_SPLIT_PASSES products each (the u
    term's 4 ch p is left out, under 1 % of the rest); at chunk 1 the
    one-token kernel's 4 p p, in f32 on the CUDA cores."""
    nbytes = 4 * (5 * b * s * h * p + h * p + 2 * b * h * p * p)
    flops = 2.0 * b * h * s * ((chunk - 1) * p + 2 * p * p)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (flops / PEAK_FLOPS["float32"] if chunk == 1
             else TF32_SPLIT_PASSES * flops / PEAK_FLOPS["tf32"])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_bound_ms(b, s, h, p, n, chunk):
    """The same for ssd_chunk: x, dt, B, C, A_log, D read once, y written
    once, the state read and written once; per chunk the products the
    function needs: the scores C B^T over the lower triangle with its
    diagonal, ch (ch + 1) / 2 entries of n multiply-adds, once per (b,
    chunk) (B and C are shared by every head), and per chunk and head their
    product with x dt (the same entries, p multiply-adds each), the carried
    state's term and the state update (2 ch n p); a last, shorter chunk
    counts its own triangle.  All on the TF32 tensor cores the kernel uses,
    TF32_SPLIT_PASSES products each."""
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + 2 * h
                  + 2 * b * h * n * p)
    rest = s % chunk
    tri = (s // chunk) * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2
    flops = 2.0 * b * tri * n + 2.0 * b * h * (tri * p + 2 * s * n * p)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = TF32_SPLIT_PASSES * flops / PEAK_FLOPS["tf32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def recurrence_case(torch, fn, plain, args, chunk, what):
    """One call of a recurrence kernel against its plain version: y and the
    final state within TOL_RECURRENCE of their largest magnitudes; then the
    same call with the final state written into the state tensor itself,
    which must give the same bits."""
    y, S = fn(*args, chunk=chunk)
    torch.cuda.synchronize()
    y_ref, S_ref = plain(*args, chunk=chunk)
    row = {}
    for tag, got, want in (("y", y, y_ref), ("state", S, S_ref)):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        lim = TOL_RECURRENCE * scale
        if not (math.isfinite(err) and err <= lim):
            fail(f"{what}: {tag} off by {err} (limit {lim})")
        row.update({f"max_err_{tag}": err, f"max_err_{tag}_limit": lim})
    state = args[-1].clone()
    y2, S2 = fn(*args[:-1], state, chunk=chunk, state_out=state)
    torch.cuda.synchronize()
    if S2 is not state or not (torch.equal(y2, y) and torch.equal(S2, S)):
        fail(f"{what}: with the state written in place the result differs")
    row["state_in_place_bit_equal"] = True
    return row


def wkv6_inputs(torch, gen, b, s, h, p, decay=0.5, state=True):
    """r, k, v ~ N(0, 1), w_log = -exp(N * decay) (the model's decay is
    -exp(w_base + LoRA)), u ~ N(0, 0.01), state ~ N(0, 0.01) or zero."""
    dev = gen.device
    r, k, v = (torch.randn((b, s, h, p), generator=gen, device=dev)
               for _ in range(3))
    w = -torch.exp(torch.randn((b, s, h, p), generator=gen, device=dev)
                   * decay)
    u = torch.randn((h, p), generator=gen, device=dev) * 0.1
    s0 = (torch.randn((b, h, p, p), generator=gen, device=dev) * 0.1
          if state else torch.zeros((b, h, p, p), device=dev))
    return [r, k, v, w, u, s0]


def ssd_inputs(torch, gen, b, s, h, p, n, state=True):
    """x, B, C ~ N(0, 1), dt = softplus(N) (the model's dt), A_log ~
    N(0, 0.09), D ~ N(0, 1), state ~ N(0, 1) or zero."""
    dev = gen.device
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    A_log = torch.randn((h,), generator=gen, device=dev) * 0.3
    B = torch.randn((b, s, n), generator=gen, device=dev)
    C = torch.randn((b, s, n), generator=gen, device=dev)
    D = torch.randn((h,), generator=gen, device=dev)
    s0 = (torch.randn((b, h, n, p), generator=gen, device=dev) if state
          else torch.zeros((b, h, n, p), device=dev))
    return [x, dt, A_log, B, C, D, s0]


def unaligned_views(torch, args):
    """ssd_chunk's inputs with the same values in tensors whose rows start
    off 16-byte boundaries: x one element into a wider last axis, B and C
    slices of one tensor, the state one element into its storage."""
    x, dt, A_log, B, C, D, s0 = args
    b, s, h, p = x.shape
    n = B.shape[-1]
    xw = torch.empty((b, s, h, p + 1), device=x.device)
    xw[..., 1:] = x
    bc = torch.empty((b, s, 2 * n + 1), device=x.device)
    bc[..., 1:n + 1], bc[..., n + 1:] = B, C
    sw = torch.empty(s0.numel() + 1, device=x.device)
    sw[1:] = s0.flatten()
    return [xw[..., 1:], dt, A_log, bc[..., 1:n + 1], bc[..., n + 1:], D,
            sw[1:].view(s0.shape)]


def wkv6_unaligned(torch, args):
    """wkv6's inputs with the same values in tensors whose rows start off
    16-byte boundaries: r, k, v and w one element into a wider last axis,
    the state one element into its storage."""
    *seqs, u, s0 = args
    out = []
    for t in seqs:
        wide = torch.empty((*t.shape[:-1], t.shape[-1] + 1), device=t.device)
        wide[..., 1:] = t
        out.append(wide[..., 1:])
    sw = torch.empty(s0.numel() + 1, device=s0.device)
    sw[1:] = s0.flatten()
    return out + [u, sw[1:].view(s0.shape)]


def check_wkv6(torch, wkv6, wkv6_plain):
    """wkv6 at rwkv6-1.6b's decode (b = 1 and 4, s = 1) and loss (b 2, s
    2048, chunk 64) shapes, ragged chunks (100, 1000), the JAX tests' shapes,
    the model's chunked-form test, and p 47 in unaligned views (the kernels'
    4-byte copy, scalar carry and one-token paths); every row also with the
    state written in place and repeated (the same bits).  The decode row at
    b = 4 is timed cycling state copies that exceed the L2 (24 layers'
    states are 48 MB), the others warm; the decode, loss and ragged rows
    also by torch.profiler per pass (the one-token kernel; state, carry,
    scan), and the decode row's host us per call."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 9)
    H, P = 32, 64
    cases = [("rwkv6 decode", 1, 1, H, P, 1, 0.5, True),
             ("rwkv6 decode", 4, 1, H, P, 1, 0.5, True),
             ("rwkv6 loss", 2, 2048, H, P, 64, 0.5, False),
             ("ragged", 1, 100, H, P, 100, 0.5, True),
             ("ragged", 1, 1000, H, P, 1000, 0.5, True),
             ("jax-test", 2, 64, 2, 16, 16, 0.5, True),
             ("jax-test", 1, 128, 3, 32, 32, 0.5, True),
             ("jax-test", 2, 32, 1, 8, 32, 0.5, True),
             ("jax-test chunked form", 1, 64, 2, 16, 16, 0.3, False),
             ("unaligned", 2, 256, 12, 47, 128, 0.5, True),
             ("unaligned", 2, 3, 12, 47, 1, 0.5, True)]
    out = []
    for name, b, s, h, p, ch, decay, state in cases:
        args = wkv6_inputs(torch, gen, b, s, h, p, decay, state)
        if name == "unaligned":
            args = wkv6_unaligned(torch, args)
        what = f"wkv6 {name} (b, s, h, p) = {(b, s, h, p)} chunk {ch}"
        row = {"case": name, "b": b, "s": s, "h": h, "p": p, "chunk": ch,
               **recurrence_case(torch, wkv6, wkv6_plain, args, ch, what)}
        y1, S1 = wkv6(*args, chunk=ch)
        y2, S2 = wkv6(*args, chunk=ch)
        torch.cuda.synchronize()
        if not (torch.equal(y1, y2) and torch.equal(S1, S2)):
            fail(f"{what}: a repeated call gives other bits")
        row["repeat_bit_equal"] = True
        del y1, S1, y2, S2
        out.append(row)
        if name not in ("rwkv6 decode", "rwkv6 loss", "ragged"):
            continue
        states = [args[-1]]
        if name == "rwkv6 decode":
            states += [args[-1].clone() for _ in range(
                math.ceil(120e6 / (4 * args[-1].numel())) - 1)]
        iters = 50 if s == 1 else 5
        t_kernel = time_ms(lambda i: wkv6(*args[:-1], states[i], chunk=ch),
                           len(states), iters)
        t_plain = time_ms(lambda i: wkv6_plain(*args[:-1], states[i],
                                               chunk=ch), len(states), iters)
        t_bound, by = wkv6_bound_ms(b, s, h, p, ch)
        row.update({"kernel_ms": t_kernel, "plain_ms": t_plain,
                    "library_ms": None, "bound_ms": t_bound, "bound_by": by,
                    "state_cold_in_l2": len(states) > 1})
        # device time by pass, over as many calls as time_ms: back-to-back
        # launches this small are timed at the host's launch rate
        prof = profile_calls(torch, {"wkv6": lambda: [
            wkv6(*args[:-1], states[i % len(states)], chunk=ch)
            for i in range(iters)]}, repeats=iters)["wkv6"]
        passes = {r["kernel"]: r["ms"] / iters for r in prof or []
                  if r["kernel"].startswith("wkv6_")
                  and r["kernel"].endswith("_kernel")}
        row["kernel_device_ms"] = sum(passes.values()) if passes else None
        row["kernel_device_ms_by_pass"] = passes or None
        if s == 1 and b == DECODE_M:
            st = states[0]
            row["host_us_per_call"] = host_us_per_call(
                torch, lambda: wkv6(*args[:-1], st, chunk=ch, state_out=st),
                200, 7)
        del states
    return out


def check_ssd(torch, ssd_chunk, ssd_chunk_plain):
    """ssd_chunk at zamba2-2.7b's loss shape (b 2, s 2048, h 80, p 64, n 64,
    chunk 64), ragged chunks (100, 1000), one decode-sized step, the JAX
    tests' shapes, and odd widths in unaligned views (the kernels' 4-byte
    copy, scalar carry and odd-column store paths); every row also with the
    state written in place and repeated (the same bits); the model's shapes
    timed (inputs of 170 MB: cold in L2), back to back by CUDA events and by
    torch.profiler per pass (state, carry, scan)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 10)
    H, P, N = 80, 64, 64
    cases = [("zamba2 loss", 2, 2048, H, P, N, 64, False),
             ("ragged", 1, 100, H, P, N, 100, True),
             ("ragged", 1, 1000, H, P, N, 1000, True),
             ("one step", 4, 1, H, P, N, 1, True),
             ("jax-test", 2, 64, 2, 16, 8, 16, False),
             ("jax-test", 1, 96, 4, 32, 16, 32, False),
             ("jax-test", 2, 32, 1, 8, 4, 8, False),
             ("jax-test nonzero state", 1, 32, 2, 8, 4, 8, True),
             ("unaligned", 2, 256, 12, 47, 37, 128, True)]
    out = []
    for name, b, s, h, p, n, ch, state in cases:
        args = ssd_inputs(torch, gen, b, s, h, p, n, state)
        if name == "unaligned":
            args = unaligned_views(torch, args)
        what = f"ssd_chunk {name} (b, s, h, p, n) = {(b, s, h, p, n)} chunk {ch}"
        row = {"case": name, "b": b, "s": s, "h": h, "p": p, "n": n,
               "chunk": ch,
               **recurrence_case(torch, ssd_chunk, ssd_chunk_plain, args, ch,
                                 what)}
        y1, S1 = ssd_chunk(*args, chunk=ch)
        y2, S2 = ssd_chunk(*args, chunk=ch)
        torch.cuda.synchronize()
        if not (torch.equal(y1, y2) and torch.equal(S1, S2)):
            fail(f"{what}: a repeated call gives other bits")
        row["repeat_bit_equal"] = True
        del y1, S1, y2, S2
        out.append(row)
        if name not in ("zamba2 loss", "ragged"):
            continue
        t_kernel = time_ms(lambda i: ssd_chunk(*args, chunk=ch), 1, 5)
        t_plain = time_ms(lambda i: ssd_chunk_plain(*args, chunk=ch), 1, 5)
        t_bound, by = ssd_bound_ms(b, s, h, p, n, ch)
        row.update({"kernel_ms": t_kernel, "plain_ms": t_plain,
                    "library_ms": None, "bound_ms": t_bound, "bound_by": by})
        iters = 5
        prof = profile_calls(torch, {"ssd_chunk": lambda: [
            ssd_chunk(*args, chunk=ch) for _ in range(iters)]},
            repeats=iters)["ssd_chunk"]
        passes = {r["kernel"]: r["ms"] / iters for r in prof or []
                  if r["kernel"].startswith("ssd_chunk_")}
        row["kernel_device_ms"] = sum(passes.values()) if passes else None
        row["kernel_device_ms_by_pass"] = passes or None
    return out


def wkv6_bwd_bound_ms(b, s, h, p, chunk, state_grad):
    """Least time for one backward pass of wkv6: r, k, v, w, dy and each
    chunk's incoming state S_in (the forward's) read once, u and the final
    state's gradient (where nonzero) read once; dr, dk, dv, dw written once,
    du and dstate written once.  Per chunk and head the products the
    gradient needs: four of ch p p (the state term rs^T dy, dy S_in^T, v
    dS_out^T, (k tail) dS_out) and five over the strictly lower triangle,
    ch (ch - 1) / 2 entries of p multiply-adds (A, dA, dA kk, A^T dy, dA^T
    rr), on the TF32 tensor cores, TF32_SPLIT_PASSES products each."""
    nc = s // chunk
    nbytes = 4 * (9 * b * s * h * p + b * h * nc * p * p + h * p
                  + (2 if state_grad else 1) * b * h * p * p)
    tri = chunk * (chunk - 1) // 2
    flops = 2.0 * b * h * nc * (4 * chunk * p * p + 5 * tri * p)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = TF32_SPLIT_PASSES * flops / PEAK_FLOPS["tf32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_bwd_bound_ms(b, s, h, p, n, chunk, state_grad):
    """The same for ssd_chunk's backward pass: x, dt, B, C, dy and each
    chunk's incoming state S_in read once, A_log, D and the final state's
    gradient (where nonzero) read once; dx, ddt, dB, dC written once,
    dA_log, dD and dstate written once.  Products: the scores C B^T over the
    inclusive triangle once per (b, chunk), ch (ch + 1) / 2 entries of n
    multiply-adds; per chunk and head four of ch n p (the state term (ec
    C)^T dy, dy S_in^T, x dt dS_out^T, B dS_out) and four over the triangle
    (dW and W^T dy, p each; dscores B and dscores^T C, n each), on the TF32
    tensor cores, TF32_SPLIT_PASSES products each."""
    nc = s // chunk
    nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n
                  + b * h * nc * n * p + 4 * h
                  + (2 if state_grad else 1) * b * h * n * p)
    tri = chunk * (chunk + 1) // 2
    flops = (2.0 * b * nc * tri * n
             + 2.0 * b * h * nc * (4 * chunk * n * p + tri * (2 * p + 2 * n)))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = TF32_SPLIT_PASSES * flops / PEAK_FLOPS["tf32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def grad_case(torch, fn, plain_bwd, args, chunk, state_grad, names,
              reduced, what, tols=None, kept=None):
    """One backward pass of a recurrence kernel through autograd (the
    wrapper's forward under autograd, then its backward kernel) against its
    plain backward version on the same inputs and output gradients: each
    gradient within TOL_RECURRENCE of its largest magnitude, the reduced
    ones (``reduced``) within TOL_REDUCED_GRAD, or within ``tols[name]``
    where given; a repeated backward pass gives the same bits.  Returns
    (row, the graph's outputs, leaves and output gradients, for timing);
    ``kept``, where given, receives the kernel's and the plain version's
    gradients and the output gradients (``got``, ``want``, ``dy``,
    ``dS``)."""
    leaves = [a.detach().requires_grad_(True) for a in args]
    y, S = fn(*leaves, chunk=chunk)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 21)
    dy = torch.randn(y.shape, generator=gen, device=DEVICE)
    dS = (torch.randn(S.shape, generator=gen, device=DEVICE)
          if state_grad else torch.zeros_like(S))
    got = torch.autograd.grad((y, S), leaves, (dy, dS), retain_graph=True)
    torch.cuda.synchronize()
    want = plain_bwd(*args, dy, dS if state_grad else None, chunk=chunk)
    row = {}
    for name, g, w in zip(names, got, want):
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        lim = ((tols or {}).get(name) or (
            TOL_REDUCED_GRAD if name in reduced else TOL_RECURRENCE)) * scale
        if not (math.isfinite(err) and err <= lim):
            fail(f"{what}: {name} off by {err} (limit {lim}, max "
                 f"{scale})")
        row.update({f"max_err_{name}": err, f"max_err_{name}_limit": lim})
    again = torch.autograd.grad((y, S), leaves, (dy, dS), retain_graph=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{what}: a repeated backward pass gives other bits")
    row["repeat_bit_equal"] = True
    if kept is not None:
        kept.update(got=got, want=want, dy=dy,
                    dS=dS if state_grad else None)
    worst = max(names, key=lambda n: row[f"max_err_{n}"]
                / max(row[f"max_err_{n}_limit"], 1e-30))
    row.update(worst_grad=worst, max_err=row[f"max_err_{worst}"],
               max_err_limit=row[f"max_err_{worst}_limit"])
    return row, (y, S, leaves, dy, dS)


def time_grad(torch, row, graph, plain_bwd, args, chunk, name, bound,
              shape):
    """A timed backward row: the backward pass alone (``autograd.grad`` of
    a kept graph: the backward kernel's launch and nothing else on the
    device) by CUDA events, its plain version on the same inputs, the byte
    and operation bound, and the device time and launches by pass
    (torch.profiler).  The device ms are held to ``BWD_LIMIT_MS[name,
    shape]`` and the launches of one call to ``BWD_LAUNCH_LIMIT``; a figure
    not measured fails."""
    y, S, leaves, dy, dS = graph
    state_grad = bool(dS.abs().max() > 0)

    def bwd():
        return torch.autograd.grad((y, S), leaves, (dy, dS),
                                   retain_graph=True)
    iters = 5
    t_kernel = time_ms(lambda i: bwd(), 1, iters)
    t_plain = time_ms(lambda i: plain_bwd(
        *args, dy, dS if state_grad else None, chunk=chunk), 1, iters)
    t_bound, by = bound
    row.update({"kernel_ms": t_kernel, "plain_ms": t_plain,
                "library_ms": None, "bound_ms": t_bound, "bound_by": by})
    prof = profile_calls(torch, {name: lambda: [bwd() for _ in range(iters)]},
                         repeats=iters)[name]
    passes = {r["kernel"]: r["ms"] / iters for r in prof or []
              if "_bwd_" in r["kernel"]}
    row["kernel_device_ms"] = sum(passes.values()) if passes else None
    row["kernel_device_ms_by_pass"] = passes or None
    row["launches_per_call"] = (sum(r["calls"] for r in prof
                                    if "_bwd_" in r["kernel"]) / iters
                                if passes else None)
    limit = BWD_LIMIT_MS[name, shape]
    row.update(device_ms_limit=limit, launches_limit=BWD_LAUNCH_LIMIT)
    what = f"{name} at the {shape} shape"
    if row["kernel_device_ms"] is None or row["kernel_device_ms"] > limit:
        fail(f"{what}: {row['kernel_device_ms']} device ms a call (null: "
             f"not measured) over its limit {limit}")
    if (row["launches_per_call"] is None
            or row["launches_per_call"] > BWD_LAUNCH_LIMIT):
        fail(f"{what}: {row['launches_per_call']} launches a call (null: "
             f"not measured) over its limit {BWD_LAUNCH_LIMIT}")


def check_wkv6_bwd(torch, wkv6, wkv6_backward_plain):
    """wkv6's backward kernel (csrc/wkv6_bwd.cu, through ``wkv6`` under
    autograd) against ``wkv6_backward_plain`` at rwkv6-1.6b's loss (b 2, s
    2048) and train (2, 256) shapes, the train shape at b 1, ragged chunks
    (100, 1000), the JAX tests' shapes and p 47 in unaligned views (chunk
    128: the multi-tile passes; chunk 64 with h 12: the fused pass at odd
    widths; chunk 1: the forward's three passes at one row), each with the
    final state's gradient zero and random, and repeated (the same bits);
    the loss and train shapes timed, by CUDA events and by pass, and held
    to ``BWD_LIMIT_MS`` and ``BWD_LAUNCH_LIMIT``."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 19)
    H, P = 32, 64
    cases = [("rwkv6 loss", 2, 2048, H, P, 64),
             ("rwkv6 train", 2, 256, H, P, 64),
             ("rwkv6 train b1", 1, 256, H, P, 64),
             ("ragged", 1, 100, H, P, 100),
             ("ragged", 1, 1000, H, P, 1000),
             ("jax-test", 2, 64, 2, 16, 16),
             ("jax-test", 1, 128, 3, 32, 32),
             ("jax-test", 2, 32, 1, 8, 32),
             ("unaligned", 2, 256, 12, 47, 128),
             ("unaligned", 2, 256, 12, 47, 64),
             ("unaligned", 2, 3, 12, 47, 1)]
    names = ("dr", "dk", "dv", "dw_log", "du", "dstate")
    out = []
    for name, b, s, h, p, ch in cases:
        for state_grad in (False, True):
            args = wkv6_inputs(torch, gen, b, s, h, p, 0.5, True)
            if name == "unaligned":
                args = wkv6_unaligned(torch, args)
            what = (f"wkv6 backward {name} (b, s, h, p) = {(b, s, h, p)} "
                    f"chunk {ch}, state gradient "
                    f"{'random' if state_grad else 'zero'}")
            row, graph = grad_case(
                torch, wkv6, wkv6_backward_plain, args, ch, state_grad,
                names, ("du", "dw_log"), what)
            row = {"case": name, "b": b, "s": s, "h": h, "p": p,
                   "chunk": ch, "state_grad": state_grad, **row}
            if name in ("rwkv6 loss", "rwkv6 train") and not state_grad:
                time_grad(torch, row, graph, wkv6_backward_plain, args, ch,
                          "wkv6_bwd",
                          wkv6_bwd_bound_ms(b, s, h, p, ch, state_grad),
                          name.split()[1])
            del graph
            out.append(row)
    return out


def wkv6_bwd_bf16_bound_ms(b, s, h, p, chunk, state_grad):
    """:func:`wkv6_bwd_bound_ms` for the bf16 recurrence: r, k, v read and
    dr, dk, dv written at 2 bytes an element, w, dy and dw at 4, S_in, u and
    the state's gradients as there; the five products over the strictly
    lower triangle on the bf16 tensor cores, the four ch p p on the TF32
    ones (TF32_SPLIT_PASSES products each)."""
    nc = s // chunk
    n = b * s * h * p
    nbytes = (2 * 6 * n + 4 * 3 * n
              + 4 * (b * h * nc * p * p + h * p
                     + (2 if state_grad else 1) * b * h * p * p))
    tri = chunk * (chunk - 1) // 2
    bf16_ops = 2.0 * b * h * nc * 5 * tri * p
    f32_ops = 2.0 * b * h * nc * 4 * chunk * p * p
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (bf16_ops / PEAK_FLOPS["bfloat16"]
             + TF32_SPLIT_PASSES * f32_ops / PEAK_FLOPS["tf32"])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_wkv6_bwd_bf16(torch, wkv6, wkv6_backward_plain):
    """wkv6's bf16 backward (``wkv6_bwd_bf16_launch``, through ``wkv6`` on
    bf16 r/k/v under autograd, the forward ``wkv6_bf16_passes_launch``)
    against ``wkv6_backward_plain`` in bf16 at rwkv6-1.6b's train (b 2, s
    256) and loss (2, 2048) shapes, the train shape at b 1, a ragged chunk
    (1000), chunk 1 (the forward's three passes at one row) and p 47 in
    strided bf16 views (chunk 128, and chunk 64 with h 12: the fused pass at
    odd widths), each with the final state's gradient zero and random: dr, dk, dv (bf16) and
    dw_log within TOL_WKV6_BF16 of their largest magnitudes, du within
    TOL_REDUCED_GRAD, dstate within TOL_RECURRENCE; where a chunk holds more
    than one row dr, dk and dv at least WKV6_BF16_SEPARATION times closer
    (relative Frobenius) to the plain bf16 backward than the plain f32
    backward on the same values is (dw_log's separation recorded); a
    repeated backward pass the same bits; each pass counted by
    ``wkv6.bf16_backward_launches`` and its forward by
    ``wkv6.bf16_launches``, none by the f32 counts.  The train and loss
    shapes timed and held as the f32 rows are."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 24)
    H, P = 32, 64
    cases = [("rwkv6 train", 2, 256, H, P, 64, False),
             ("rwkv6 loss", 2, 2048, H, P, 64, False),
             ("rwkv6 train b1", 1, 256, H, P, 64, False),
             ("ragged", 1, 1000, H, P, 1000, False),
             ("chunk 1", 2, 16, H, P, 1, False),
             ("strided", 2, 256, 12, 47, 128, True),
             ("strided", 2, 256, 12, 47, 64, True)]
    names = ("dr", "dk", "dv", "dw_log", "du", "dstate")
    tols = {"dr": TOL_WKV6_BF16, "dk": TOL_WKV6_BF16, "dv": TOL_WKV6_BF16,
            "dw_log": TOL_WKV6_BF16, "du": TOL_REDUCED_GRAD,
            "dstate": TOL_RECURRENCE}
    counts = ("bf16_launches", "bf16_backward_launches", "launches",
              "backward_launches")
    out = []
    for name, b, s, h, p, ch, strided in cases:
        for state_grad in (False, True):
            args = wkv6_bf16_inputs(torch, gen, b, s, h, p, strided)
            what = (f"wkv6 bf16 backward {name} (b, s, h, p) = "
                    f"{(b, s, h, p)} chunk {ch}, state gradient "
                    f"{'random' if state_grad else 'zero'}")
            before = [getattr(wkv6, c) for c in counts]
            kept = {}
            row, graph = grad_case(
                torch, wkv6, wkv6_backward_plain, args, ch, state_grad,
                names, (), what, tols=tols, kept=kept)
            torch.cuda.synchronize()
            moved = [getattr(wkv6, c) - n for c, n in zip(counts, before)]
            if moved != [1, 2, 0, 0]:
                fail(f"{what}: launches {dict(zip(counts, moved))} for one "
                     f"forward and two backward passes")
            got, want = kept["got"], kept["want"]
            if [g.dtype for g in got[:3]] != [torch.bfloat16] * 3:
                fail(f"{what}: dr, dk, dv in {[g.dtype for g in got[:3]]}")
            f32 = wkv6_backward_plain(*args, kept["dy"], kept["dS"],
                                      chunk=ch, compute_dtype=torch.float32)
            row = {"case": name, "b": b, "s": s, "h": h, "p": p,
                   "chunk": ch, "state_grad": state_grad,
                   "strided": strided, **row}
            for i, g_name in enumerate(names[:4]):
                k_fro = fro_rel(got[i], want[i])
                f_fro = fro_rel(f32[i], want[i])
                sep = f_fro / k_fro if k_fro else math.inf
                row.update({f"fro_{g_name}_rel": k_fro,
                            f"f32_route_fro_{g_name}_rel": f_fro,
                            f"separation_{g_name}": sep})
                if ch > 1 and g_name != "dw_log" and not (
                        sep >= WKV6_BF16_SEPARATION):
                    fail(f"{what}: {g_name} is {k_fro} from the plain bf16 "
                         f"backward (relative Frobenius), the f32 backward "
                         f"{f_fro}: less than {WKV6_BF16_SEPARATION} times "
                         f"closer, the bf16 roundings are not shown")
            del got, want, f32, kept
            if name in ("rwkv6 loss", "rwkv6 train") and not state_grad:
                time_grad(torch, row, graph, wkv6_backward_plain, args, ch,
                          "wkv6_bwd_bf16",
                          wkv6_bwd_bf16_bound_ms(b, s, h, p, ch, state_grad),
                          name.split()[1])
            del graph
            out.append(row)
    return out


def check_ssd_bwd(torch, ssd_chunk, ssd_chunk_backward_plain):
    """ssd_chunk's backward kernel (csrc/ssd_chunk_bwd.cu, through
    ``ssd_chunk`` under autograd) against ``ssd_chunk_backward_plain`` at
    zamba2-2.7b's loss (b 2, s 2048, h 80, p 64, n 64) and train (2, 256)
    shapes, the train shape at b 1 (one head a block where b 2 takes two),
    ragged chunks (100, 1000), the JAX tests' shapes and odd widths in
    unaligned views (chunk 128: the multi-tile passes; chunk 64 with h 12:
    the fused pass with a partial head group at p 47, n 37), each with the
    final state's gradient zero and random, and repeated (the same bits);
    the loss and train shapes timed and held to ``BWD_LIMIT_MS`` and
    ``BWD_LAUNCH_LIMIT``."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 20)
    H, P, N = 80, 64, 64
    cases = [("zamba2 loss", 2, 2048, H, P, N, 64),
             ("zamba2 train", 2, 256, H, P, N, 64),
             ("zamba2 train b1", 1, 256, H, P, N, 64),
             ("ragged", 1, 100, H, P, N, 100),
             ("ragged", 1, 1000, H, P, N, 1000),
             ("jax-test", 2, 64, 2, 16, 8, 16),
             ("jax-test", 1, 96, 4, 32, 16, 32),
             ("jax-test", 2, 32, 1, 8, 4, 8),
             ("unaligned", 2, 256, 12, 47, 37, 128),
             ("unaligned", 2, 256, 12, 47, 37, 64)]
    names = ("dx", "ddt", "dA_log", "dB", "dC", "dD", "dstate")
    out = []
    for name, b, s, h, p, n, ch in cases:
        for state_grad in (False, True):
            args = ssd_inputs(torch, gen, b, s, h, p, n, True)
            if name == "unaligned":
                args = unaligned_views(torch, args)
            what = (f"ssd_chunk backward {name} (b, s, h, p, n) = "
                    f"{(b, s, h, p, n)} chunk {ch}, state gradient "
                    f"{'random' if state_grad else 'zero'}")
            row, graph = grad_case(
                torch, ssd_chunk, ssd_chunk_backward_plain, args, ch,
                state_grad, names, ("dA_log", "dD"), what)
            row = {"case": name, "b": b, "s": s, "h": h, "p": p, "n": n,
                   "chunk": ch, "state_grad": state_grad, **row}
            if name in ("zamba2 loss", "zamba2 train") and not state_grad:
                time_grad(torch, row, graph, ssd_chunk_backward_plain, args,
                          ch, "ssd_chunk_bwd",
                          ssd_bwd_bound_ms(b, s, h, p, n, ch, state_grad),
                          name.split()[1])
            del graph
            out.append(row)
    return out


@contextlib.contextmanager
def plain_route(ssm_mod, wkv6_plain, ssd_chunk_plain):
    """The model's two recurrences on their plain versions (for a reference
    on the card); restored on exit."""
    def wkv(*args, chunk, state_out=None):
        y, S = wkv6_plain(*args, chunk=chunk)
        return y, (S if state_out is None else state_out.copy_(S))

    def ssd(*args, chunk, state_out=None):
        y, S = ssd_chunk_plain(*args, chunk=chunk)
        return y, (S if state_out is None else state_out.copy_(S))

    saved = ssm_mod.wkv6, ssm_mod.ssd_chunk
    ssm_mod.wkv6, ssm_mod.ssd_chunk = wkv, ssd
    try:
        yield
    finally:
        ssm_mod.wkv6, ssm_mod.ssd_chunk = saved


class Counters:
    """The launch counts of the kernels a path may run."""

    #: a wrapper's counts, where it has them: its kernels' launches, its
    #: backward kernels', and (wkv6) its bf16 variants' of both
    COUNTS = ("launches", "backward_launches", "bf16_launches",
              "bf16_backward_launches")

    def __init__(self, **wrappers):
        self.wrappers = wrappers

    def zero(self):
        for fn in self.wrappers.values():
            for count in self.COUNTS:
                if hasattr(fn, count):
                    setattr(fn, count, 0)

    def _read(self, count):
        return {name: getattr(fn, count)
                for name, fn in self.wrappers.items() if hasattr(fn, count)}

    def read(self):
        return self._read("launches")

    def read_backward(self):
        """The backward kernels' launches (the recurrences' gradients)."""
        return self._read("backward_launches")

    def read_bf16(self):
        """The bf16 variants' launches: (forward, backward)."""
        return (self._read("bf16_launches"),
                self._read("bf16_backward_launches"))


def logits_alone(torch, api, params, prompt, fed, backend, use_backend,
                 get_backend, shape_cls):
    """The logits of one request alone after ``prompt`` and ``fed`` (an
    ssm/hybrid prompt is absorbed by decode steps at batch 1)."""
    state = api.make_decode_state(shape_cls("serve", MAX_LEN, 1, "decode"))
    with use_backend(get_backend(backend)):
        for t in list(prompt) + list(fed):
            logits, state = api.decode_step(
                params, state, torch.tensor([[t]], device=DEVICE))
    return logits[0].float()


def serve_ssm(torch, arch, cfg, params, mods, counters):
    """rwkv6-1.6b or zamba2-2.7b through the launcher at full width, the
    phi4 phase's traffic under ``reference``: GEMM and kernel counts, tokens
    equal to a ``slots=1`` run's, tokens under ``ideal`` equal up to ties."""
    serve_mod, use_backend, get_backend = (mods.serve, mods.use_backend,
                                           mods.get_backend)
    per_step = sum(w[2] for w in SSM_GEMMS[arch](cfg).values())
    argv = ["--arch", arch, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--requests", str(REQUESTS), "--max-new", str(MAX_NEW), "--mixed",
            "--seed", str(SEED)]
    for backend in ("reference", "ideal"):          # warm-up, uncounted
        serve_mod.run(serve_mod.parse_args(
            ["--arch", arch, "--slots", "2", "--max-len", str(MAX_LEN),
             "--requests", "2", "--max-new", "2", "--backend", backend]),
            params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts set to 0 just before, read just after
    counters.zero()
    run = serve_mod.run(serve_mod.parse_args(argv + ["--backend",
                                                     "reference"]), params)
    torch.cuda.synchronize()
    launches = counters.read()
    stats, tel = run.stats, run.stats.backend_telemetry
    steps = stats.model_steps
    if stats.completed != REQUESTS or stats.truncated or stats.unserved:
        fail(f"serve_ssm {arch}: {stats.completed} of {REQUESTS} completed, "
             f"{stats.truncated} truncated, {stats.unserved} unserved")
    if not launches["systolic_mac"] == tel["calls"] == per_step * steps:
        fail(f"serve_ssm {arch}: {launches['systolic_mac']} systolic_mac "
             f"launches, {tel['calls']} backend GEMMs, expected {per_step} "
             f"x {steps} model steps")
    want_wkv6 = cfg.n_layers * steps if cfg.family == "ssm" else 0
    if launches["wkv6"] != want_wkv6 or launches["ssd_chunk"] != 0:
        fail(f"serve_ssm {arch}: wkv6 launched {launches['wkv6']} times "
             f"(expected {want_wkv6}), ssd_chunk {launches['ssd_chunk']}")
    if tel["flags"] != 0:
        fail(f"serve_ssm {arch}: {tel['flags']} flags at nominal rails")
    for r in run.requests:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab for t in r.out_tokens):
            fail(f"serve_ssm {arch}: request {r.uid} produced "
                 f"{r.out_tokens}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # ---- beside it: one slot at a time (must be equal), and under ideal
    # (equal up to ties, the C1 rule: where the streams part, the
    # reference's token lies within 2 x TOL_LOGITS of the ideal logits'
    # maximum; how far apart the two backends' logits lie there is printed)
    run1 = serve_mod.run(serve_mod.parse_args(
        argv[:2] + ["--slots", "1"] + argv[4:] + ["--backend", "reference"]),
        params)
    if [r.out_tokens for r in run.requests] != [r.out_tokens
                                               for r in run1.requests]:
        fail(f"serve_ssm {arch}: tokens differ from a slots=1 run")
    ideal = serve_mod.run(serve_mod.parse_args(argv + ["--backend", "ideal"]),
                          params)
    api = mods.model_api(cfg)
    parted, worst_gap, worst_err = 0, 0.0, 0.0
    for r_ref, r_id in zip(run.requests, ideal.requests):
        a, b = r_ref.out_tokens, r_id.out_tokens
        if a == b:
            continue
        parted += 1
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        alone = [logits_alone(torch, api, params, r_ref.prompt, a[:i], be,
                              use_backend, get_backend, mods.ShapeConfig)
                 for be in ("ideal", "reference")]
        scale = float(alone[0].abs().max())
        gap = float(alone[0].max() - alone[0][a[i]]) / scale
        err = float((alone[1] - alone[0]).abs().max()) / scale
        worst_gap, worst_err = max(worst_gap, gap), max(worst_err, err)
        if gap > 2 * TOL_LOGITS:
            fail(f"serve_ssm {arch}: request {r_ref.uid} parts from ideal "
                 f"at token {i} with a gap of {gap} of max|logits| (limit "
                 f"{2 * TOL_LOGITS}); the backends' logits lie {err} apart")
    return {
        "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": mods.param_count(params), "backend": "reference",
        "slots": SLOTS,
        "max_len": MAX_LEN, "requests": REQUESTS,
        "completed": stats.completed, "prefill_steps": stats.prefill_steps,
        "decode_steps": stats.decode_steps, "model_steps": steps,
        "tokens_generated": stats.tokens_generated,
        "gemm_calls": tel["calls"], "gemms_per_model_step": per_step,
        "launches": launches,
        "wkv6_launches_per_model_step": launches["wkv6"] / steps,
        "macs": tel["macs"], "flags": tel["flags"], "wall_s": run.wall_s,
        "model_step_ms": 1e3 * run.wall_s / steps,
        "tokens_per_s": stats.tokens_generated / run.wall_s,
        "ttft_mean_s": sum(stats.ttft_s) / len(stats.ttft_s),
        "peak_device_memory_gb": peak_gb,
        "tokens_equal_to_slots_1": True,
        "ideal_tokens_per_s": ideal.stats.tokens_generated / ideal.wall_s,
        "ideal_model_step_ms": 1e3 * ideal.wall_s / ideal.stats.model_steps,
        "requests_parting_from_ideal": parted,
        "worst_gap_at_parting": worst_gap, "worst_logits_err_at_parting":
        worst_err, "tie_limit": 2 * TOL_LOGITS}


def decode_vs_parallel(torch, cfg, params, api, ssm_mod, layers_mod,
                       shape_cls, counters, wkv6_plain, ssd_chunk_plain):
    """Last-position logits of the parallel forward (the loss path's
    backbone: wkv6 / ssd_chunk at the model's chunk) against token-by-token
    decode_step, both under ``ideal``, within TOL_LOGITS of max|logits|, at
    prompts of 64 tokens (chunk 64), 60 and 100 (one ragged chunk of the
    whole prompt); for zamba2 also three Mamba2 layers alone (the first, a
    middle and the last), ``mamba2_forward`` against ``mamba2_step`` over
    the same input, within TOL_DECODE_PARALLEL.

    One exception, the reference's own: rwkv6's chunked form centres a
    chunk's decay exponents at half its total and clamps them at +-60, so
    where a channel decays by more than 120 within one chunk the chunked form
    departs from the recurrence (ROADMAP.md C6; the JAX package's parallel
    forward departs the same way).  There the departure must come with such
    a chunk, every wkv6 call of the parallel forward must lie within
    TOL_RECURRENCE of the plain version on the same inputs (y and the final
    state), the parallel forward on the plain versions must depart from
    decode too, and the parallel forward on the kernels must lie within
    TOL_LOGITS of the one on the plain versions, unless the same run shows
    that no kernel short of the plain version's own f32 summation order
    could: when seeded noise of WKV6_NOISE_PROBE of their largest magnitude
    on the plain route's wkv6 outputs moves its last logits by TOL_LOGITS or
    more (``plain_route_under_noise_rel``), the logits are reported beside
    each other (``logits_held`` false) and the per-call check stands alone;
    B4's products run on the TF32 tensor cores."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 11)
    backbone = (ssm_mod.rwkv6_backbone if cfg.family == "ssm"
                else ssm_mod.zamba2_backbone)
    decays, call_errs = [], []
    kernel_wkv6 = ssm_mod.wkv6

    def rel(got, want):
        return float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)

    def recording_wkv6(r, k, v, w_log, u, state, *, chunk, **kw):
        total = -w_log.reshape(w_log.shape[0], -1, chunk,
                               *w_log.shape[2:]).sum(2)
        decays.append(float(total.max()) / 2)
        # the plain version first: state_out may be the state
        y_ref, S_ref = wkv6_plain(r, k, v, w_log, u, state, chunk=chunk)
        y, S = kernel_wkv6(r, k, v, w_log, u, state, chunk=chunk, **kw)
        call_errs.append(max(rel(y, y_ref), rel(S, S_ref)))
        return y, S

    def parallel(toks):
        with torch.inference_mode():
            y = backbone(params, layers_mod.embed(toks, params), cfg)
            return layers_mod.logits_last(y[:, -1:], params["embedding"])

    out = []
    for T in (64, 60, 100):
        toks = torch.randint(3, cfg.vocab_size, (1, T), generator=gen,
                             device=DEVICE)
        decays.clear()
        call_errs.clear()
        counters.zero()
        ssm_mod.wkv6 = recording_wkv6
        try:
            full = parallel(toks)
        finally:
            ssm_mod.wkv6 = kernel_wkv6
        torch.cuda.synchronize()
        launches = counters.read()
        want = {"wkv6": cfg.n_layers if cfg.family == "ssm" else 0,
                "ssd_chunk": cfg.n_layers if cfg.family == "hybrid" else 0}
        if any(launches[k] != v for k, v in want.items()):
            fail(f"decode_vs_parallel {cfg.name} T={T}: launches {launches}, "
                 f"expected {want}")
        state = api.make_decode_state(shape_cls("t", T, 1, "decode"))
        for t in range(T):
            dec, state = api.decode_step(params, state, toks[:, t:t + 1])
        scale = float(full.abs().max())
        err = float((dec - full).abs().max()) / scale
        row = {"T": T, "chunk": ssm_mod._chunk(cfg.ssm_chunk, T),
               "parallel_launches": {k: launches[k] for k in want},
               "max_err_rel": err, "limit": TOL_LOGITS}
        if decays:
            row["max_half_chunk_decay"] = max(decays)
            row["wkv6_calls_max_err_rel"] = max(call_errs)
            row["wkv6_calls_limit"] = TOL_RECURRENCE
            if not max(call_errs) <= TOL_RECURRENCE:
                fail(f"decode_vs_parallel {cfg.name} T={T}: a wkv6 call of "
                     f"the parallel forward is {max(call_errs)} of its "
                     f"largest magnitude from the plain version (limit "
                     f"{TOL_RECURRENCE})")
        if not math.isfinite(err):
            fail(f"decode_vs_parallel {cfg.name} T={T}: not finite")
        if err >= TOL_LOGITS:
            if not (decays and max(decays) > WKV6_CLAMP):
                fail(f"decode_vs_parallel {cfg.name} T={T}: {err} of "
                     f"max|logits| (limit {TOL_LOGITS})")
            counters.zero()
            noise = torch.Generator(device=DEVICE)
            noise.manual_seed(SEED + 13)
            with plain_route(ssm_mod, wkv6_plain, ssd_chunk_plain):
                ref = parallel(toks)
                plain_wkv6 = ssm_mod.wkv6

                def noisy_wkv6(*args, **kw):
                    y, S = plain_wkv6(*args, **kw)
                    return y + WKV6_NOISE_PROBE * float(y.abs().max()) * (
                        torch.randn(y.shape, generator=noise,
                                    device=y.device)), S
                ssm_mod.wkv6 = noisy_wkv6
                try:
                    ref_noisy = parallel(toks)
                finally:
                    ssm_mod.wkv6 = plain_wkv6
            if any(counters.read()[k] for k in want):
                fail(f"decode_vs_parallel {cfg.name} T={T}: the plain route "
                     f"launched a kernel")
            ref_scale = float(ref.abs().max())
            plain_departs = float((dec - ref).abs().max()) / ref_scale
            if not plain_departs >= TOL_LOGITS:
                fail(f"decode_vs_parallel {cfg.name} T={T}: decode departs "
                     f"from the parallel forward on the kernels ({err}) but "
                     f"not from the one on the plain versions "
                     f"({plain_departs}; limit {TOL_LOGITS})")
            gap = float((full - ref).abs().max()) / ref_scale
            under_noise = float((ref_noisy - ref).abs().max()) / ref_scale
            held = under_noise < TOL_LOGITS
            if held and not gap < TOL_LOGITS:
                fail(f"decode_vs_parallel {cfg.name} T={T}: the parallel "
                     f"forward is {gap} of max|logits| from the plain "
                     f"route's (limit {TOL_LOGITS}; noise of "
                     f"{WKV6_NOISE_PROBE} moves it by {under_noise})")
            row.update({
                "departs_as_the_reference": "ROADMAP.md C6",
                "plain_route_vs_decode_rel": plain_departs,
                "parallel_vs_plain_route_rel": gap,
                "plain_route_under_noise_rel": under_noise,
                "noise_probe_rel": WKV6_NOISE_PROBE,
                "logits_held": held})
        if cfg.family == "hybrid":
            row["mamba2_layers_alone"] = mamba2_alone(
                torch, cfg, params, ssm_mod, gen, T)
        out.append(row)
    return out


def mamba2_alone(torch, cfg, params, ssm_mod, gen, T):
    """Mamba2 layers 0, L/2 and L-1 of zamba2 on one N(0, 1) input of T
    tokens: the parallel forward (ssd_chunk at the model's chunk) against
    T recurrent steps, within TOL_DECODE_PARALLEL of the largest output."""
    dims = ssm_mod.mamba2_dims(cfg)
    x = torch.randn((1, T, cfg.d_model), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    rows = []
    with torch.inference_mode():
        for i in (0, cfg.n_layers // 2, cfg.n_layers - 1):
            lp = {k: v[i] for k, v in params["mamba"].items()}
            y_par = ssm_mod.mamba2_forward(x, lp, cfg)
            ssm_s = torch.zeros((1, dims["n_heads"], dims["d_state"],
                                 dims["p"]), device=DEVICE)
            conv_s = torch.zeros((1, 3, dims["conv_dim"]), device=DEVICE,
                                 dtype=torch.bfloat16)
            ys = []
            for t in range(T):
                y, ssm_s, conv_s = ssm_mod.mamba2_step(x[:, t:t + 1], lp, cfg,
                                                       ssm_s, conv_s)
                ys.append(y)
            y_dec = torch.cat(ys, dim=1)
            err = float((y_dec.float() - y_par.float()).abs().max()
                        / y_par.float().abs().max())
            if not (math.isfinite(err) and err < TOL_DECODE_PARALLEL):
                fail(f"decode_vs_parallel {cfg.name} Mamba2 layer {i} T={T}: "
                     f"{err} of the largest output (limit "
                     f"{TOL_DECODE_PARALLEL})")
            rows.append({"layer": i, "max_err_rel": err,
                         "limit": TOL_DECODE_PARALLEL})
    return rows


def loss_phase(torch, cfg, params, api, ssm_mod, plains, counters):
    """``ModelAPI.loss`` on a seeded (2, 2048) batch under ``ideal``:
    finite and near ln(V) for random weights, equal (TOL_LOSS relative) to
    the same loss with the two recurrences on their plain versions; seconds
    per call, the kernels' launches and a profile by CUDA kernel."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 12)
    b, s = LOSS_BATCH
    toks = torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                         device=DEVICE)
    labels = torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                           device=DEVICE)
    batch = {"tokens": toks, "labels": labels}
    api.loss(params, batch)                      # warm-up
    torch.cuda.synchronize()
    counters.zero()
    t0 = time.monotonic()
    loss = float(api.loss(params, batch))
    seconds = time.monotonic() - t0
    launches = counters.read()
    kernel = "wkv6" if cfg.family == "ssm" else "ssd_chunk"
    if launches[kernel] != cfg.n_layers:
        fail(f"loss {cfg.name}: {kernel} launched {launches[kernel]} times, "
             f"expected {cfg.n_layers}")
    ln_v = math.log(cfg.padded_vocab)
    if not (math.isfinite(loss) and 0.5 * ln_v < loss < 2 * ln_v):
        fail(f"loss {cfg.name}: {loss} (random weights: near ln V = {ln_v})")
    times = []
    for _ in range(2):
        t0 = time.monotonic()
        float(api.loss(params, batch))
        times.append(time.monotonic() - t0)
    counters.zero()
    with plain_route(ssm_mod, *plains):
        loss_plain = float(api.loss(params, batch))
    if counters.read()[kernel] != 0:
        fail(f"loss {cfg.name}: the plain route launched {kernel}")
    gap = abs(loss - loss_plain) / abs(loss_plain)
    if not gap <= TOL_LOSS:
        fail(f"loss {cfg.name}: {loss} on the kernels, {loss_plain} on the "
             f"plain versions (gap {gap}, limit {TOL_LOSS})")
    rows = profile_calls(torch, {"loss": lambda: api.loss(params, batch)})
    by_name = {}
    for r in rows["loss"] or []:
        acc = by_name.setdefault(r["kernel"], [0.0, 0])
        acc[0] += r["ms"]
        acc[1] += r["calls"]
    device_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # every CUDA kernel of the wrapper: its passes, <kernel>_<pass>_kernel
    passes = {k: v[0] for k, v in by_name.items()
              if k.startswith(f"{kernel}_") and k.endswith("_kernel")}
    k_ms = sum(passes.values()) if passes else None
    seconds_mean = (seconds + sum(times)) / 3
    return {"arch": cfg.name, "batch": [b, s], "backend": "ideal",
            "loss": loss, "loss_plain_route": loss_plain,
            "loss_gap_rel": gap, "loss_gap_limit": TOL_LOSS,
            "ln_padded_vocab": ln_v, "seconds_per_call": seconds_mean,
            "tokens_per_s": b * s / seconds_mean, "launches": launches,
            f"{kernel}_ms_per_launch": (None if k_ms is None
                                        else k_ms / cfg.n_layers),
            f"{kernel}_ms_per_call": k_ms,
            f"{kernel}_ms_per_call_by_kernel": passes or None,
            f"{kernel}_share_of_device_ms": (None if not (k_ms and device_ms)
                                             else k_ms / device_ms),
            "device_ms_per_call": device_ms or None,
            "profile_top_kernels": [
                {"kernel": k, "ms": v[0], "calls": v[1],
                 "share": v[0] / device_ms} for k, v in top] or None}


# ---------------------------------------------------------------------------
# wkv6 with bf16 operands (cfg.ssm_bf16=True)
# ---------------------------------------------------------------------------


def wkv6_bf16_bound_ms(b, s, h, p, chunk):
    """Least time for one bf16 wkv6 call: r, k, v read once at 2 bytes, w
    read once, y written once (f32), u read once, the state read and written
    once (f32); per chunk and head the score tile's strictly lower entries
    and their product with v (2 ch (ch - 1) p operations) on the bf16 tensor
    cores, the carried state's term and the update (4 ch p p) on the TF32
    tensor cores, TF32_SPLIT_PASSES products each; at chunk 1 the one-token
    kernel's 4 p p in f32 on the CUDA cores."""
    n = b * s * h * p
    nbytes = 2 * 3 * n + 4 * 2 * n + 4 * (h * p + 2 * b * h * p * p)
    bf16_ops = 2.0 * b * h * s * (chunk - 1) * p
    f32_ops = 4.0 * b * h * s * p * p
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (f32_ops / PEAK_FLOPS["float32"] if chunk == 1
             else bf16_ops / PEAK_FLOPS["bfloat16"]
             + TF32_SPLIT_PASSES * f32_ops / PEAK_FLOPS["tf32"])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wkv6_bf16_inputs(torch, gen, b, s, h, p, strided=False):
    """:func:`wkv6_inputs` with r, k and v in bf16 (the model's operands
    under ssm_bf16); ``strided``: r, k and v one element into a wider last
    axis, rows off any alignment."""
    args = wkv6_inputs(torch, gen, b, s, h, p)
    for i in range(3):
        x = args[i].to(torch.bfloat16)
        if strided:
            wide = torch.empty((b, s, h, p + 1), dtype=torch.bfloat16,
                               device=x.device)
            wide[..., 1:] = x
            x = wide[..., 1:]
        args[i] = x
    return args


def fro_rel(got, want):
    """||got - want||_F / ||want||_F, in f64."""
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm().clamp_min(1e-300))


def bf16_separation(y, y_ref, y32):
    """The bf16 wkv6's y and the f32 route's y against the plain bf16 y:
    relative Frobenius norms, their ratio (f32 over kernel; inf where the
    kernel is bit-equal), and the share of elements off by more than one
    f32 rounding of the largest magnitude."""
    ulp = 2.0 ** -23 * float(y_ref.abs().max())
    k_fro, f_fro = fro_rel(y, y_ref), fro_rel(y32, y_ref)
    return {"fro_y_rel": k_fro, "f32_route_fro_y_rel": f_fro,
            "separation": f_fro / k_fro if k_fro else math.inf,
            "share_off_y": float(((y - y_ref).abs() > ulp).double().mean()),
            "f32_route_share_off_y": float(
                ((y32 - y_ref).abs() > ulp).double().mean())}


def check_wkv6_bf16(torch, wkv6, wkv6_plain):
    """The bf16 wkv6 (``wkv6_bf16_launch``) against its plain bf16 version
    on the card: rwkv6-1.6b's loss shape (b 2, s 2048, chunk 64) and decode
    shapes (b 1 and 4, s 1), ragged chunks (100, 1000), one chunk (64), a
    strided p 47; y within TOL_WKV6_BF16 and the state within TOL_RECURRENCE of
    their largest magnitudes, the state written in place and a repeated
    call the same bits, each call counted by ``wkv6.bf16_launches`` and
    none by ``wkv6.launches``; where the chunk holds more than one row, y
    at least WKV6_BF16_SEPARATION times closer (relative Frobenius norm)
    to the plain bf16 version than the f32 route is (at chunk 1 the two
    routes are one function, and the f32 route must equal the plain bf16
    version).  The loss and decode rows are timed beside
    the f32 kernel on the same values (f32 copies of r, k and v) and beside
    the plain version, with device ms by pass for both kernels; at the loss
    shape the bf16 call's device ms is held to WKV6_BF16_LIMIT_MS and below
    the f32 kernel's (a figure not measured fails).  Each row records
    whether r, k and v were staged by 16-byte copies (``rows16``)."""
    from repro_torch.kernels.wkv6 import rows16
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 21)
    out = []
    for name, b, s, h, p, ch, strided in WKV6_BF16_CASES:
        args = wkv6_bf16_inputs(torch, gen, b, s, h, p, strided)
        what = f"wkv6 bf16 {name} (b, s, h, p) = {(b, s, h, p)} chunk {ch}"
        n0, f0 = wkv6.bf16_launches, wkv6.launches
        y, S = wkv6(*args, chunk=ch)
        y2, S2 = wkv6(*args, chunk=ch)
        state = args[-1].clone()
        y3, S3 = wkv6(*args[:-1], state, chunk=ch, state_out=state)
        torch.cuda.synchronize()
        if (wkv6.bf16_launches - n0, wkv6.launches - f0) != (3, 0):
            fail(f"{what}: {wkv6.bf16_launches - n0} bf16 and "
                 f"{wkv6.launches - f0} f32 launches for 3 calls")
        if not (torch.equal(y, y2) and torch.equal(S, S2)):
            fail(f"{what}: a repeated call gives other bits")
        if S3 is not state or not (torch.equal(y3, y) and torch.equal(S3, S)):
            fail(f"{what}: with the state written in place the result "
                 f"differs")
        y_ref, S_ref = wkv6_plain(*args, chunk=ch,
                                  compute_dtype=torch.bfloat16)
        y32, _ = wkv6_plain(*args, chunk=ch, compute_dtype=torch.float32)
        row = {"case": name, "b": b, "s": s, "h": h, "p": p, "chunk": ch,
               "repeat_bit_equal": True, "state_in_place_bit_equal": True,
               "rkv_rows16": [rows16(t) for t in args[:3]]}
        for tag, got, want, tol in (("y", y, y_ref, TOL_WKV6_BF16),
                                    ("state", S, S_ref, TOL_RECURRENCE)):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            if not (math.isfinite(err) and err <= tol * scale):
                fail(f"{what}: {tag} off by {err} (limit {tol * scale})")
            row.update({f"max_err_{tag}": err,
                        f"max_err_{tag}_limit": tol * scale})
        row["f32_route_gap_y_rel"] = float(
            (y32 - y_ref).abs().max()) / float(y_ref.abs().max())
        row.update(bf16_separation(y, y_ref, y32))
        if ch > 1 and not (row["separation"] >= WKV6_BF16_SEPARATION):
            fail(f"{what}: y is {row['fro_y_rel']} from the plain bf16 "
                 f"version (relative Frobenius), the f32 route "
                 f"{row['f32_route_fro_y_rel']}: less than "
                 f"{WKV6_BF16_SEPARATION} times closer, the bf16 roundings "
                 f"are not shown")
        if ch == 1 and not torch.equal(y32, y_ref):
            fail(f"{what}: at chunk 1 the f32 route differs from the plain "
                 f"bf16 version")
        del y2, S2, y3, S3, y32
        out.append(row)
        if name not in ("rwkv6 loss", "rwkv6 decode") or (s == 1 and b != 4):
            continue
        f32_args = [t.to(torch.float32) for t in args[:3]] + args[3:]
        iters = 50 if s == 1 else 5
        t_kernel = time_ms(lambda i: wkv6(*args, chunk=ch), 1, iters)
        t_f32 = time_ms(lambda i: wkv6(*f32_args, chunk=ch), 1, iters)
        t_plain = time_ms(lambda i: wkv6_plain(*args, chunk=ch), 1,
                          min(iters, 5))
        t_bound, by = wkv6_bf16_bound_ms(b, s, h, p, ch)
        prof = profile_calls(torch, {
            "wkv6": lambda: [wkv6(*args, chunk=ch) for _ in range(iters)],
            "wkv6_f32": lambda: [wkv6(*f32_args, chunk=ch)
                                 for _ in range(iters)]}, repeats=iters)
        passes, f32_passes = ({r["kernel"]: r["ms"] / iters
                               for r in prof[key] or []
                               if r["kernel"].startswith("wkv6_")
                               and r["kernel"].endswith("_kernel")}
                              for key in ("wkv6", "wkv6_f32"))
        row.update({"kernel_ms": t_kernel, "f32_kernel_ms": t_f32,
                    "plain_ms": t_plain, "library_ms": None,
                    "bound_ms": t_bound, "bound_by": by,
                    "f32_bound_ms": wkv6_bound_ms(b, s, h, p, ch)[0],
                    "kernel_device_ms": (sum(passes.values()) if passes
                                         else None),
                    "kernel_device_ms_by_pass": passes or None,
                    "f32_kernel_device_ms": (sum(f32_passes.values())
                                             if f32_passes else None),
                    "f32_kernel_device_ms_by_pass": f32_passes or None})
        if name == "rwkv6 loss":
            dev, dev32 = row["kernel_device_ms"], row["f32_kernel_device_ms"]
            row["limit_ms"] = WKV6_BF16_LIMIT_MS
            if dev is None or dev32 is None:
                fail(f"{what}: device ms not measured (bf16 {dev}, f32 "
                     f"{dev32}; profiler tries {PROFILE_MISSES[-2:]})")
            if not dev <= WKV6_BF16_LIMIT_MS:
                fail(f"{what}: {dev} device ms a call (limit "
                     f"{WKV6_BF16_LIMIT_MS}; by pass {passes})")
            if not dev < dev32:
                fail(f"{what}: {dev} device ms a call, not below the f32 "
                     f"kernel's {dev32} on the same values (by pass "
                     f"{passes} against {f32_passes})")
        if s == 1:
            st = args[-1]
            row["host_us_per_call"] = host_us_per_call(
                torch, lambda: wkv6(*args[:-1], st, chunk=ch, state_out=st),
                200, 7)
    return out


def wkv6_bf16_model(torch, cfg, params, mods, ssm_mod, plains, counters,
                    wkv6):
    """rwkv6-1.6b at full width with ``ssm_bf16=True`` (the serve phase's
    weights): ``ModelAPI.loss`` on ``reference`` (a seeded WKV6_BF16_LOSS
    batch) against the same loss with the recurrence on its plain bf16
    version (TOL_LOSS), and beside the f32 recurrence and the plain bf16
    route under WKV6_NOISE_PROBE of noise (printed, not held: at full
    depth the loss moves as far under that noise as between the two
    recurrences, so it cannot tell them apart); the loss run again with
    every layer's wkv6 call held to WKV6_BF16_SEPARATION against its plain
    bf16 and f32 routes on the call's own inputs (the check that can);
    then the launcher's traffic on ``reference`` (the bf16 wkv6's launches =
    layers x model steps, none of the f32 kernel's, B1's = the routed
    GEMMs), and one served request replayed alone: each step's logits on
    the kernel against the plain bf16 route's same step (from a copy of the
    kernel's state) within TOL_BF16_LOGITS of max|logits|, unless seeded
    noise of WKV6_NOISE_PROBE on the plain route's wkv6 outputs moves them
    that far (decode_vs_parallel's rule, ROADMAP C6: at full depth it
    does), then within TOL_LOGITS; every wkv6 call of the kernel's steps
    held to the plain bf16 version on its own inputs; the f32 recurrence's
    step printed beside them."""
    cfg_bf = dataclasses.replace(cfg, ssm_bf16=True)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 22)
    b, s = WKV6_BF16_LOSS
    toks = torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                         device=DEVICE)
    labels = torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                           device=DEVICE)
    batch = {"tokens": toks, "labels": labels}
    api_bf = mods.model_api(cfg_bf, backend="reference")
    api_f32 = mods.model_api(cfg, backend="reference")
    api_bf.loss(params, batch)                      # warm-up
    torch.cuda.synchronize()
    counters.zero()
    wkv6.bf16_launches = 0
    t0 = time.monotonic()
    loss = float(api_bf.loss(params, batch))
    loss_s = time.monotonic() - t0
    launches = {**counters.read(), "wkv6_bf16": wkv6.bf16_launches}
    if launches["wkv6_bf16"] != cfg.n_layers or launches["wkv6"] != 0:
        fail(f"wkv6_bf16 loss: {launches} launches, expected "
             f"{cfg.n_layers} of the bf16 wkv6 and none of the f32")
    with plain_route(ssm_mod, *plains):
        loss_plain = float(api_bf.loss(params, batch))
    loss_f32 = float(api_f32.loss(params, batch))
    gap = abs(loss - loss_plain) / abs(loss_plain)
    ln_v = math.log(cfg.padded_vocab)
    if not (math.isfinite(loss) and 0.5 * ln_v < loss < 2 * ln_v
            and gap <= TOL_LOSS):
        fail(f"wkv6_bf16 loss: {loss} on the kernel, {loss_plain} on the "
             f"plain bf16 route (gap {gap}, limit {TOL_LOSS})")
    wkv6_plain, kernel_wkv6 = plains[0], ssm_mod.wkv6
    noise_gen = torch.Generator(device=DEVICE)
    noise_gen.manual_seed(SEED + 23)

    def noisy(*args, chunk, state_out=None):
        y, S = wkv6_plain(*args, chunk=chunk)
        y = y + WKV6_NOISE_PROBE * float(y.abs().max()) * torch.randn(
            y.shape, generator=noise_gen, device=y.device)
        return y, (S if state_out is None else state_out.copy_(S))

    ssm_mod.wkv6 = noisy
    try:
        loss_noisy = float(api_bf.loss(params, batch))
    finally:
        ssm_mod.wkv6 = kernel_wkv6
    loss_seps = []

    def separated(r, k, v, w_log, u, state, *, chunk, **kw):
        # the plain versions first: state_out may be the state
        y_ref, _ = wkv6_plain(r, k, v, w_log, u, state, chunk=chunk)
        y32, _ = wkv6_plain(r, k, v, w_log, u, state, chunk=chunk,
                            compute_dtype=torch.float32)
        y, S = kernel_wkv6(r, k, v, w_log, u, state, chunk=chunk, **kw)
        loss_seps.append((chunk, bf16_separation(y, y_ref, y32)))
        return y, S

    ssm_mod.wkv6 = separated
    try:
        api_bf.loss(params, batch)
    finally:
        ssm_mod.wkv6 = kernel_wkv6
    weakest = min(sep["separation"] for _, sep in loss_seps)
    if len(loss_seps) != cfg.n_layers or not all(
            ch > 1 and sep["separation"] >= WKV6_BF16_SEPARATION
            for ch, sep in loss_seps):
        fail(f"wkv6_bf16 loss: {len(loss_seps)} wkv6 calls at chunks "
             f"{sorted({ch for ch, _ in loss_seps})}; the weakest lies "
             f"{weakest} times closer to the plain bf16 version than the f32 "
             f"route (limit {WKV6_BF16_SEPARATION})")

    # the launcher's traffic, bf16 recurrence, reference
    argv = ["--arch", cfg.name, "--slots", str(SLOTS), "--max-len",
            str(MAX_LEN), "--requests", str(WKV6_BF16_REQUESTS), "--max-new",
            str(WKV6_BF16_NEW), "--mixed", "--seed", str(SEED), "--backend",
            "reference"]
    per_step = sum(w[2] for w in SSM_GEMMS[cfg.name](cfg).values())
    with depth_cut(mods.serve, cfg_bf):
        counters.zero()
        wkv6.bf16_launches = 0
        run = mods.serve.run(mods.serve.parse_args(argv), params)
        torch.cuda.synchronize()
        served = {**counters.read(), "wkv6_bf16": wkv6.bf16_launches}
    stats, tel = run.stats, run.stats.backend_telemetry
    steps = stats.model_steps
    if stats.completed != WKV6_BF16_REQUESTS or stats.truncated:
        fail(f"wkv6_bf16 serve: {stats.completed} of {WKV6_BF16_REQUESTS} "
             f"completed, {stats.truncated} truncated")
    if not (served["wkv6_bf16"] == cfg.n_layers * steps
            and served["wkv6"] == 0
            and served["systolic_mac"] == tel["calls"] == per_step * steps):
        fail(f"wkv6_bf16 serve: launches {served} over {steps} model steps "
             f"({tel['calls']} routed GEMMs, {per_step} a step)")

    # one request alone, replayed on the kernel; at every step the plain
    # bf16 route, the same route with WKV6_NOISE_PROBE of noise on each wkv6
    # output, and the f32 recurrence run the same step from a copy of the
    # kernel's state, and every wkv6 call of the kernel's step is held to
    # the plain bf16 version on its own inputs (y, state)
    req = run.requests[0]
    fed = list(req.prompt) + list(req.out_tokens[:-1])
    shape1 = mods.ShapeConfig("serve", MAX_LEN, 1, "decode")
    st_k = api_bf.make_decode_state(shape1)
    call_errs = []

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1e-30)

    def checked(r, k, v, w_log, u, state, *, chunk, **kw):
        # the plain version first: state_out may be the state
        y_ref, S_ref = wkv6_plain(r, k, v, w_log, u, state, chunk=chunk)
        y, S = kernel_wkv6(r, k, v, w_log, u, state, chunk=chunk, **kw)
        call_errs.append((rel(y, y_ref), rel(S, S_ref)))
        return y, S

    worst = worst_f32 = probe = 0.0
    for t in fed:
        tok = torch.tensor([[t]], device=DEVICE)
        copies = [{k: v.clone() for k, v in st_k.items()} for _ in range(3)]
        with plain_route(ssm_mod, *plains):
            plain, _ = api_bf.decode_step(params, copies[0], tok)
        ssm_mod.wkv6 = noisy
        try:
            moved, _ = api_bf.decode_step(params, copies[1], tok)
        finally:
            ssm_mod.wkv6 = kernel_wkv6
        f32, _ = api_f32.decode_step(params, copies[2], tok)
        ssm_mod.wkv6 = checked
        try:
            kern, st_k = api_bf.decode_step(params, st_k, tok)
        finally:
            ssm_mod.wkv6 = kernel_wkv6
        worst = max(worst, rel(kern, plain))
        worst_f32 = max(worst_f32, rel(f32, plain))
        probe = max(probe, rel(moved, plain))
    if len(call_errs) != cfg.n_layers * len(fed) or not all(
            ey <= TOL_WKV6_BF16 and es <= TOL_RECURRENCE
            for ey, es in call_errs):
        fail(f"wkv6_bf16 replay: {len(call_errs)} wkv6 calls, worst (y, "
             f"state) error {max(call_errs)} (limits {TOL_WKV6_BF16}, "
             f"{TOL_RECURRENCE})")
    # the logits are held within TOL_BF16_LOGITS where the noise probe shows
    # that a kernel short of the plain version's own summation order could
    # meet it; at rwkv6's full depth it moves them further, and the kernel's
    # logits are held within TOL_LOGITS (the card's full-depth limit)
    limit = TOL_BF16_LOGITS if probe < TOL_BF16_LOGITS else TOL_LOGITS
    if not (math.isfinite(worst) and worst <= limit):
        fail(f"wkv6_bf16 logits: {worst} of max|logits| from the plain bf16 "
             f"route (limit {limit}; the noise probe moves them {probe})")
    print(f"wkv6_bf16: rwkv6-1.6b loss {loss:.6f} (plain bf16 route "
          f"{loss_plain:.6f}, f32 recurrence {loss_f32:.6f}, plain bf16 "
          f"route under noise {loss_noisy:.6f}); each layer's wkv6 at least "
          f"{weakest:.1f} times closer to the plain bf16 version than the "
          f"f32 route; decode logits "
          f"{worst:.3e} of max from the plain bf16 route a step (noise probe "
          f"{probe:.3e}, limit {limit}), the f32 recurrence {worst_f32:.3e}",
          flush=True)
    return {"arch": cfg.name, "ssm_bf16": True, "backend": "reference",
            "loss_batch": [b, s], "loss": loss, "loss_plain_bf16_route":
            loss_plain, "loss_gap_rel": gap, "loss_gap_limit": TOL_LOSS,
            "loss_f32_recurrence": loss_f32,
            "loss_gap_to_f32_rel": abs(loss - loss_f32) / abs(loss_f32),
            "loss_plain_bf16_route_under_noise": loss_noisy,
            "loss_noise_probe_rel": abs(loss_noisy - loss_plain) / abs(
                loss_plain),
            "loss_wkv6_separation": {
                "calls": len(loss_seps), "chunks": sorted(
                    {ch for ch, _ in loss_seps}),
                "limit": WKV6_BF16_SEPARATION, "weakest": weakest,
                "by_layer": [sep for _, sep in loss_seps]},
            "loss_seconds": loss_s, "loss_launches": launches,
            "serve": {"requests": WKV6_BF16_REQUESTS, "model_steps": steps,
                      "launches": served, "gemm_calls": tel["calls"],
                      "flags": tel["flags"], "wall_s": run.wall_s,
                      "model_step_ms": 1e3 * run.wall_s / steps,
                      "tokens": [r.out_tokens for r in run.requests]},
            "replayed_steps": len(fed),
            "logits_err_vs_plain_bf16_rel": worst,
            "logits_err_limit": limit,
            "logits_held_to_bf16_tol": limit == TOL_BF16_LOGITS,
            "plain_route_under_noise_rel": probe,
            "wkv6_calls_checked": len(call_errs),
            "wkv6_call_max_err_rel": [max(e[0] for e in call_errs),
                                      max(e[1] for e in call_errs)],
            "logits_gap_f32_recurrence_rel": worst_f32}


def release(torch):
    """Free what the last model left before the next is made: its engines
    and requests hold reference cycles, which keep its parameters alive
    until the collector runs; then hand the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def family_config(get_config, arch):
    """``arch`` at published width, its depth cut where one card cannot
    hold it (FAMILY_LAYERS); the row's ``reduced`` says so."""
    cfg = get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    return cfg


@contextlib.contextmanager
def depth_cut(serve_mod, cfg):
    """The launcher builds ``cfg`` (a depth cut of its arch) where it would
    build the published config, inside the block."""
    saved = serve_mod.get_config

    def get_config(arch, smoke=False):
        if arch == cfg.name and not smoke:
            return cfg
        return saved(arch, smoke=smoke)
    serve_mod.get_config = get_config
    try:
        yield
    finally:
        serve_mod.get_config = saved


@contextlib.contextmanager
def recording_routes(layers_mod, sink):
    """Each MoE routing decision (the expert indices, on the device) is
    appended to ``sink`` inside the block."""
    inner = layers_mod._router

    def router(x, p, cfg):
        w, idx, probs = inner(x, p, cfg)
        sink.append(idx)
        return w, idx, probs
    layers_mod._router = router
    try:
        yield
    finally:
        layers_mod._router = inner


def alone_steps(torch, api, params, req, frames, backend, mods):
    """One served request alone on ``backend``: its prompt (and frames), then
    its served tokens fed back but the last; the logits (f32) after the
    prompt and after each token."""
    out = []
    with mods.use_backend(mods.get_backend(backend)):
        batch = {"tokens": torch.tensor([req.prompt], device=DEVICE)}
        if api.cfg.family == "encdec":
            batch["frames"] = frames
        logits, state = api.prefill(params, batch, max_len=MAX_LEN)
        out.append(logits[0].float())
        for t in req.out_tokens[:-1]:
            logits, state = api.decode_step(
                params, state, torch.tensor([[t]], device=DEVICE))
            out.append(logits[0].float())
    return out


def serve_family(torch, arch, cfg, params, mods, counters, layers_mod):
    """seamless-m4t-medium, llama4-scout-17b-a16e (depth cut) or
    llava-next-mistral-7b through the launcher at published width, the phi4
    phase's traffic under ``reference``: GEMM and kernel counts, zero flags,
    tokens equal to a ``slots=1`` run's and under ``ideal`` equal up to ties
    (C1).  Each request alone on both backends gives the logits' largest gap
    and, for llama4, the routing decisions that differ; seamless is also
    served with seeded frames on its requests."""
    serve_mod = mods.serve
    prefill_gemms, decode_gemms = family_gemms(cfg)
    argv = ["--arch", arch, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--requests", str(REQUESTS), "--max-new", str(MAX_NEW), "--mixed",
            "--seed", str(SEED)]

    def check_run(what, stats, launches, requests):
        tel = stats.backend_telemetry
        want = (prefill_gemms * stats.prefill_steps
                + decode_gemms * stats.decode_steps)
        if stats.completed != REQUESTS or stats.truncated or stats.unserved:
            fail(f"{what}: {stats.completed} of {REQUESTS} completed, "
                 f"{stats.truncated} truncated, {stats.unserved} unserved")
        if not launches["systolic_mac"] == tel["calls"] == want:
            fail(f"{what}: {launches['systolic_mac']} systolic_mac launches, "
                 f"{tel['calls']} backend GEMMs, expected {prefill_gemms} x "
                 f"{stats.prefill_steps} prefill + {decode_gemms} x "
                 f"{stats.decode_steps} decode steps")
        if tel["flags"] != 0:
            fail(f"{what}: {tel['flags']} flags at nominal rails")
        for r in requests:
            if len(r.out_tokens) != r.max_new_tokens or not all(
                    0 <= t < cfg.padded_vocab for t in r.out_tokens):
                fail(f"{what}: request {r.uid} produced {r.out_tokens}")

    with depth_cut(serve_mod, cfg):
        for backend in ("reference", "ideal"):          # warm-up, uncounted
            serve_mod.run(serve_mod.parse_args(
                ["--arch", arch, "--slots", "2", "--max-len", str(MAX_LEN),
                 "--requests", "2", "--max-new", "2", "--backend", backend]),
                params)
        torch.cuda.synchronize()

        # ---- the main path: counts set to 0 just before, read just after
        counters.zero()
        run = serve_mod.run(serve_mod.parse_args(argv + ["--backend",
                                                         "reference"]), params)
        torch.cuda.synchronize()
        launches = counters.read()
        stats, tel = run.stats, run.stats.backend_telemetry
        check_run(f"serve_families {arch}", stats, launches, run.requests)

        # ---- beside it: one slot at a time (must be equal), under ideal
        # (equal up to ties), each request alone on both backends
        run1 = serve_mod.run(serve_mod.parse_args(
            argv[:2] + ["--slots", "1"] + argv[4:]
            + ["--backend", "reference"]), params)
        if [r.out_tokens for r in run.requests] != [r.out_tokens
                                                   for r in run1.requests]:
            fail(f"serve_families {arch}: tokens differ from a slots=1 run")
        ideal = serve_mod.run(serve_mod.parse_args(argv + ["--backend",
                                                           "ideal"]), params)
    api = mods.model_api(cfg)
    # the frames the engine gives a request that carries none
    frames = torch.zeros((1, MAX_LEN // cfg.enc_frames_ratio, cfg.d_model),
                         dtype=torch.bfloat16, device=DEVICE)
    alone, routes = {}, {"reference": [], "ideal": []}
    for backend in ("reference", "ideal"):
        with recording_routes(layers_mod, routes[backend]):
            alone[backend] = [alone_steps(torch, api, params, r, frames,
                                          backend, mods)
                              for r in run.requests]
    for r, steps in zip(run.requests, alone["reference"]):
        if [int(lg.argmax()) for lg in steps] != r.out_tokens:
            fail(f"serve_families {arch}: request {r.uid} alone gives other "
                 f"tokens than served beside the others")
    worst_err = max(float((a - b).abs().max()) / float(b.abs().max())
                    for ra, rb in zip(alone["reference"], alone["ideal"])
                    for a, b in zip(ra, rb))
    parted, worst_gap = tokens_up_to_ties(
        torch, run.requests, ideal.requests,
        lambda r, fed: alone["ideal"][r.uid][len(fed)],
        f"serve_families {arch} reference against ideal")
    if len(routes["reference"]) != len(routes["ideal"]):
        fail(f"serve_families {arch}: {len(routes['reference'])} routing "
             f"calls on reference, {len(routes['ideal'])} on ideal")
    routings = sum(int((a != b).any(-1).sum())
                   for a, b in zip(routes["reference"], routes["ideal"]))
    route_rows = sum(int(x.shape[0]) for x in routes["reference"])
    row = {
        "arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": mods.param_count(params),
        "backend": "reference", "slots": SLOTS, "max_len": MAX_LEN,
        "requests": REQUESTS, "completed": stats.completed,
        "prefill_steps": stats.prefill_steps,
        "decode_steps": stats.decode_steps,
        "tokens_generated": stats.tokens_generated,
        "gemm_calls": tel["calls"], "gemms_per_prefill": prefill_gemms,
        "gemms_per_decode_step": decode_gemms, "launches": launches,
        "macs": tel["macs"], "flags": tel["flags"], "wall_s": run.wall_s,
        "model_step_ms": 1e3 * run.wall_s / stats.model_steps,
        "tokens_per_s": stats.tokens_generated / run.wall_s,
        "ttft_mean_s": sum(stats.ttft_s) / len(stats.ttft_s),
        "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens_equal_to_slots_1": True,
        "alone_tokens_equal_to_served": True,
        "ideal_tokens_per_s": ideal.stats.tokens_generated / ideal.wall_s,
        "ideal_model_step_ms": 1e3 * ideal.wall_s / ideal.stats.model_steps,
        "requests_parting_from_ideal": parted,
        "worst_gap_at_parting": worst_gap,
        "worst_logits_err_vs_ideal_alone": worst_err,
        "tie_limit": 2 * TOL_LOGITS}
    if cfg.n_experts:
        # not bounded: where a routing differs, that token's expert output
        # is another function's, so its logits are too; the tokens are held
        # to the C1 rule above
        row["routings_differing_from_ideal"] = routings
        row["routings_compared"] = route_rows
    if arch in FAMILY_LAYERS:
        row["reduced"] = {"n_layers": [mods.get_config(arch).n_layers,
                                       cfg.n_layers],
                          "why": "one card holds 8 of the 48 layers with "
                                 "the 2.07 GB embedding (about 37 GB of "
                                 "bf16); the whole model is about 211 GB"}
    if cfg.family == "encdec":
        with depth_cut(serve_mod, cfg):
            row["with_frames"] = encdec_frames_run(
                torch, cfg, params, mods, counters, check_run, argv,
                run.requests)
    return row


def encdec_frames_run(torch, cfg, params, mods, counters, check_run, argv,
                      zero_frame_requests):
    """The seamless traffic again, each request carrying seeded nonzero
    frames of ``MAX_LEN // enc_frames_ratio`` positions: counts as the main
    run, tokens equal to a ``slots=1`` run's, and at least one request's
    tokens moved by its frames (the engine reads ``Request.frames``)."""
    serve_mod = mods.serve
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 30)
    frames = [torch.randn((1, MAX_LEN // cfg.enc_frames_ratio, cfg.d_model),
                          generator=gen, device=DEVICE).to(torch.bfloat16)
              for _ in range(REQUESTS)]

    def served(slots):
        args = serve_mod.parse_args(argv[:2] + ["--slots", str(slots)]
                                    + argv[4:] + ["--backend", "reference"])
        engine = serve_mod.build_engine(args, params)
        reqs = serve_mod.make_requests(engine.cfg, REQUESTS, MAX_NEW, True,
                                       SEED)
        for r in reqs:
            r.frames = frames[r.uid]
        counters.zero()
        for r in reqs:
            engine.submit(r)
        t0 = time.monotonic()
        stats = engine.run_until_drained()
        torch.cuda.synchronize()
        return reqs, stats, counters.read(), time.monotonic() - t0

    reqs, stats, launches, wall = served(SLOTS)
    check_run(f"serve_families {cfg.name} with frames", stats, launches,
              reqs)
    reqs1, *_ = served(1)
    if [r.out_tokens for r in reqs] != [r.out_tokens for r in reqs1]:
        fail(f"serve_families {cfg.name} with frames: tokens differ from a "
             f"slots=1 run")
    moved = sum(a.out_tokens != b.out_tokens
                for a, b in zip(reqs, zero_frame_requests))
    if moved == 0:
        fail(f"serve_families {cfg.name}: no request's tokens moved with its "
             f"frames")
    return {"frames_shape": list(frames[0].shape),
            "gemm_calls": stats.backend_telemetry["calls"],
            "launches": launches, "completed": stats.completed,
            "model_step_ms": 1e3 * wall / stats.model_steps,
            "tokens_equal_to_slots_1": True,
            "requests_moved_by_frames": moved}


def frontend_loss(torch, cfg, params, api, mods, counters):
    """``ModelAPI.loss`` on a seeded (1, 256) batch (seamless: with seeded
    frames of 64 positions) under ``reference`` and under ``ideal``: finite,
    near ln(V) for random weights, the two within TOL_LOSS relative; B1
    launches = the backend's GEMM calls; seconds per call."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 31)
    b, s = FRONTEND_LOSS
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                                     device=DEVICE),
             "labels": torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                                     device=DEVICE)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (b, s // cfg.enc_frames_ratio, cfg.d_model), generator=gen,
            device=DEVICE).to(torch.bfloat16)
    out = {}
    for backend in ("ideal", "reference"):
        be = mods.get_backend(backend)
        with mods.use_backend(be):
            api.loss(params, batch)                      # warm-up
            torch.cuda.synchronize()
            counters.zero()
            calls0 = be.summary()["calls"] if backend != "ideal" else 0
            t0 = time.monotonic()
            loss = float(api.loss(params, batch))
            seconds = time.monotonic() - t0
            launches = counters.read()["systolic_mac"]
            calls = be.summary()["calls"] - calls0 if backend != "ideal" \
                else 0
        if launches != calls:
            fail(f"frontends loss {cfg.name} {backend}: {launches} "
                 f"systolic_mac launches for {calls} GEMM calls")
        out[backend] = {"loss": loss, "seconds_per_call": seconds,
                        "systolic_mac_launches": launches}
    ln_v = math.log(cfg.padded_vocab)
    ref, ideal = out["reference"]["loss"], out["ideal"]["loss"]
    gap = abs(ref - ideal) / abs(ideal)
    if not (math.isfinite(ref) and 0.5 * ln_v < ref < 2 * ln_v):
        fail(f"frontends loss {cfg.name}: {ref} (random weights: near ln V "
             f"= {ln_v})")
    if not gap <= TOL_LOSS:
        fail(f"frontends loss {cfg.name}: {ref} on reference, {ideal} on "
             f"ideal (gap {gap}, limit {TOL_LOSS})")
    return {"arch": cfg.name, "what": "loss", "batch": [b, s],
            **({"frames": list(batch["frames"].shape)}
               if "frames" in batch else {}),
            "by_backend": out, "loss_gap_rel": gap, "loss_gap_limit": TOL_LOSS,
            "ln_padded_vocab": ln_v}


def hold_b1_limit(what, ms):
    """B1's device ms on a path held to ``B1_LIMIT_MS[what]``; a figure not
    measured (None) fails."""
    limit = B1_LIMIT_MS[what]
    if ms is None or not (math.isfinite(ms) and ms <= limit):
        fail(f"B1 {what}: {ms} device ms (limit {limit} ms; a figure not "
             f"measured fails)")


def vlm_prefill(torch, cfg, params, api, mods, counters, plain):
    """llava's ``ModelAPI.prefill`` at published width with seeded patch
    embeddings (1, 2880, d) in front of a 64-token prompt, then 8 decode
    steps, under ``reference`` (B1 launches = 225 a model call) and under
    ``ideal`` with the reference's tokens fed: prefill logits within
    TOL_LOGITS, tokens equal up to ties (C1) at every step; the reference
    prefill's device time by kernel (B1 at M = 2944), and its GEMMs on their
    own operands (:func:`prefill_gemms`)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 32)
    p = cfg.frontend_tokens
    batch = {"patch_embeds": torch.randn((1, p, cfg.d_model), generator=gen,
                                         device=DEVICE).to(torch.bfloat16),
             "tokens": torch.randint(3, cfg.vocab_size, (1, VLM_PROMPT),
                                     generator=gen, device=DEVICE)}
    s = p + VLM_PROMPT
    max_len = s + VLM_STEPS
    per_call = family_gemms(cfg)[1]

    def steps(backend, fed=None):
        out, toks = [], []
        with mods.use_backend(mods.get_backend(backend)):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits, state = api.prefill(params, batch, max_len=max_len)
            torch.cuda.synchronize()
            prefill_s = time.monotonic() - t0
            if state["index"].tolist() != [s]:
                fail(f"frontends llava prefill: index {state['index']}, "
                     f"expected {s}")
            for i in range(VLM_STEPS + 1):
                out.append(logits[0].float())
                toks.append(int(logits[0].argmax()))
                if i == VLM_STEPS:
                    break
                t = toks[-1] if fed is None else fed[i]
                logits, state = api.decode_step(
                    params, state, torch.tensor([[t]], device=DEVICE))
        return out, toks, prefill_s

    steps("reference")                                   # warm-up
    counters.zero()
    ref, ref_toks, ref_s = steps("reference")
    torch.cuda.synchronize()
    launches = counters.read()["systolic_mac"]
    if launches != per_call * (VLM_STEPS + 1):
        fail(f"frontends llava prefill: {launches} systolic_mac launches, "
             f"expected {per_call} x {VLM_STEPS + 1} model calls")
    ideal, ideal_toks, ideal_s = steps("ideal", fed=ref_toks)
    scale = float(ideal[0].abs().max())
    err = float((ref[0] - ideal[0]).abs().max())
    if not (bool(torch.isfinite(ref[0]).all()) and err <= TOL_LOGITS * scale):
        fail(f"frontends llava prefill: logits differ from ideal by {err} "
             f"(limit {TOL_LOGITS * scale})")
    worst_gap, parted = 0.0, 0
    for i, (lr, li) in enumerate(zip(ref, ideal)):
        t = ref_toks[i]
        if t == ideal_toks[i]:
            continue
        parted += 1
        gap = float(li.max() - li[t]) / float(li.abs().max())
        worst_gap = max(worst_gap, gap)
        if gap > 2 * TOL_LOGITS:
            fail(f"frontends llava: step {i} parts from ideal with a gap of "
                 f"{gap} of max|logits| (limit {2 * TOL_LOGITS})")
    with mods.use_backend(mods.get_backend("reference")):
        prof = profile_calls(torch, {"prefill": lambda: api.prefill(
            params, batch, max_len=max_len)})["prefill"]
    b1 = None if prof is None else sum(r["ms"] for r in prof
                                       if r["kernel"] == "systolic_mac_kernel")
    hold_b1_limit("llava_prefill", b1)
    gemms = prefill_gemms(torch, api, params, batch, max_len, mods, plain)
    if gemms["calls"] != per_call:
        fail(f"frontends llava prefill: {gemms['calls']} GEMMs recorded, "
             f"expected {per_call}")
    return {"arch": cfg.name, "what": "prefill with patch embeddings",
            "patch_positions": p, "prompt_tokens": VLM_PROMPT,
            "index": s, "decode_steps": VLM_STEPS,
            "systolic_mac_launches": launches,
            "prefill_s": {"reference": ref_s, "ideal": ideal_s},
            "prefill_logits_max_err_vs_ideal": err,
            "prefill_logits_max_err_limit": TOL_LOGITS * scale,
            "steps_parting_from_ideal": parted,
            "worst_gap_at_parting": worst_gap, "tie_limit": 2 * TOL_LOGITS,
            "prefill_device_ms": (None if prof is None
                                  else sum(r["ms"] for r in prof)),
            "prefill_systolic_mac_device_ms": b1,
            "prefill_systolic_mac_limit_ms": B1_LIMIT_MS["llava_prefill"],
            "prefill_systolic_mac_M": s,
            "prefill_top_kernels": None if prof is None else prof[:6],
            "prefill_gemms": gemms}


def prefill_gemms(torch, api, params, batch, max_len, mods, plain):
    """Every GEMM of one ``reference`` prefill, recorded as the backend
    hands it to B1 (the operands where and as they lie): each launched
    again and held against the plain version within TOL_CLEAN of its
    largest magnitude at nominal rails, then all of them timed back to back
    by events (B1 as the backend launches it, the plain version,
    ``torch.matmul`` of the same operands) beside the sum of their bounds."""
    systolic_mac_plain, largest_common_block = plain
    be = mods.get_backend("reference")
    ops, execute = [], be._execute

    def recording(a, b, count_flags, counter):
        ops.append((a, b))
        return execute(a, b, count_flags, counter)
    be._execute = recording
    try:
        with mods.use_backend(be):
            api.prefill(params, batch, max_len=max_len)
    finally:
        del be._execute
    rails, bounds, worst = [], [], 0.0
    for a, b in ops:
        (m, k), n = a.shape, b.shape[1]
        block = largest_common_block(m, n)
        grid = (m // block, n // block)
        rails.append((torch.ones(grid, device=a.device),
                      torch.zeros(grid, device=a.device), block))
        c, _ = execute(a, b, False, None)
        c_ref, flags = systolic_mac_plain(a, b, *rails[-1][:2],
                                          block_m=block, block_n=block)
        ratio = float((c - c_ref).abs().max()) / (
            TOL_CLEAN * float(c_ref.abs().max()))
        if not (math.isfinite(ratio) and ratio <= 1 and int(flags.sum()) == 0):
            fail(f"frontends llava prefill GEMM ({m}, {k}) x ({k}, {n}): "
                 f"{ratio} of the limit, {int(flags.sum())} flags")
        worst = max(worst, ratio)
        bounds.append(bound_ms(m, k, n, *grid,
                               str(a.dtype).replace("torch.", "")))
        del c, c_ref
    n_ops = len(ops)

    def plain_call(i):
        (a, b), (v, vs, block) = ops[i], rails[i]
        return systolic_mac_plain(a, b, v, vs, block_m=block, block_n=block)
    times = {
        name: n_ops * time_ms(fn, n_ops, n_ops) for name, fn in (
            ("ms", lambda i: execute(*ops[i], False, None)),
            ("plain_ms", plain_call),
            ("library_ms", lambda i: torch.matmul(*ops[i])))}
    by = {}
    for _, kind in bounds:
        by[kind] = by.get(kind, 0) + 1
    return {"calls": n_ops,
            "M": sorted({a.shape[0] for a, _ in ops}),
            "max_err_over_limit": worst, "limit_rel": TOL_CLEAN, **times,
            "bound_ms": sum(t for t, _ in bounds), "bound_by": by}


SSM_GEMMS = {"rwkv6-1.6b": rwkv6_gemms, "zamba2-2.7b": zamba2_gemms}
FAMILY_GEMMS = {"encdec": encdec_gemms, "moe": moe_gemms, "vlm": dense_gemms}


def train_gemms(cfg):
    """name -> (K, N, launches per train step, transposed view?, dtype) of
    every GEMM B1 runs in a dense model's train step under ``reference``:
    the forward's, and the block heads' again in the backward pass (every
    GEMM but the MLP's down projection, ``models/lm.py::_block``); the
    backward's products are ``torch.matmul``."""
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    L, bf = cfg.n_layers, "bfloat16"
    return {"wq/wo": (d, qd, 4 * L, False, bf),
            "wk/wv": (d, kvd, 4 * L, False, bf),
            "w1/wg": (d, ff, 4 * L, False, bf),
            "w2": (ff, d, L, False, bf),
            "logits": (d, cfg.padded_vocab, 1, True, bf)}


@contextlib.contextmanager
def recording_optimizer(torch, optim_mod, adamw_mod, norms, spans):
    """Inside the block each step's global gradient norm is kept as the
    0-d tensor the optimizer computed (``norms``), and every AdamW update
    is bracketed by two CUDA events (``spans``).  Neither reads the device:
    the timed steps keep the trainer's own synchronisation, the one read of
    the loss a step.  Read both after the block (:func:`read_recorded`)."""
    real_norm, real_apply = adamw_mod.global_norm, optim_mod.apply_updates

    def norm(tree):
        n = real_norm(tree)
        norms.append(n.detach())
        return n

    def apply(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_apply(*args, **kw)
        end.record()
        spans.append((start, end))
        return out
    adamw_mod.global_norm, optim_mod.apply_updates = norm, apply
    try:
        yield
    finally:
        adamw_mod.global_norm, optim_mod.apply_updates = real_norm, real_apply


def read_recorded(torch, norms, spans):
    """(the norms as floats, each update's seconds on the stream between
    its two events) once the device is done."""
    torch.cuda.synchronize()
    return ([float(n) for n in norms],
            [start.elapsed_time(end) / 1e3 for start, end in spans])


def train_batch(torch, cfg, tmods, step):
    """The trainer's batch at ``step`` for TRAIN_BATCH, on the card (with
    the frontend's inputs: seamless's frames)."""
    data = tmods.DataConfig(
        vocab_size=cfg.padded_vocab, seq_len=TRAIN_BATCH[1],
        global_batch=TRAIN_BATCH[0], seed=SEED,
        mean_doc_len=max(TRAIN_BATCH[1] // 8, 8), frontend=cfg.frontend,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
        enc_frames_ratio=cfg.enc_frames_ratio)
    batch = tmods.SyntheticDataset(data).batch_at(step).data
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def train_run(torch, cfg, mods, tmods, counters, backend, opt_cfg, steps,
              gemms=None):
    """``repro_torch.train.train`` at full width for ``steps`` steps on
    ``backend``, from ``init_params(SEED)``: losses, seconds a step (the
    trainer's heartbeats), the optimizer's seconds a step on the stream,
    step 0's global gradient norm (both recorded without a host
    synchronisation: :func:`recording_optimizer`), peak memory, B1 launches and the backend's telemetry;
    then one more step under ``torch.profiler`` (device ms a step by
    kernel, B1's part).  The launches are read before the profiled step.
    ``gemms``: B1 launches a step under ``reference`` (a dense model's 13 L
    + 1 by default); the recurrences' forward and backward launches are
    recorded beside them."""
    shape = mods.ShapeConfig("train", TRAIN_BATCH[1], TRAIN_BATCH[0], "train")
    gemms = 13 * cfg.n_layers + 1 if gemms is None else gemms
    be = mods.get_backend(backend)
    monitor = tmods.HeartbeatMonitor(num_hosts=1)
    norms, spans = [], []
    release(torch)
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    counters.zero()
    t0 = time.monotonic()
    with mods.use_backend(be), recording_optimizer(
            torch, tmods.optim, tmods.adamw, norms, spans):
        res = tmods.train(cfg, shape, tmods.TrainConfig(
            steps=steps, log_every=0, checkpoint_every=0, seed=SEED),
            opt_cfg, monitor=monitor)
    norms, opt_s = read_recorded(torch, norms, spans)
    seconds = time.monotonic() - t0
    kernel_launches = counters.read()
    backward_launches = counters.read_backward()
    bf16_launches, bf16_backward_launches = counters.read_bf16()
    launches = kernel_launches["systolic_mac"]
    summary = be.summary() if backend != "ideal" else None
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = list(monitor.hosts[0].durations)
    steady = step_s[1:] or step_s
    row = {"backend": backend, "steps": steps,
           "int8_moments": opt_cfg.int8_moments, "losses": res.losses,
           "step_s": step_s, "step_s_mean_after_first": sum(steady)
           / len(steady),
           "tokens_per_s": TRAIN_M * len(steady) / sum(steady),
           "optimizer_stream_s": opt_s,
           "optimizer_stream_s_mean_after_first": sum(opt_s[1:] or opt_s)
           / len(opt_s[1:] or opt_s),
           "global_grad_norm": norms, "peak_device_memory_gb": peak,
           "device_memory_held_before_gb": held_gb,
           "seconds": seconds, "systolic_mac_launches": launches,
           "systolic_mac_launches_per_step": launches / steps,
           "recurrence_launches": {k: v for k, v in kernel_launches.items()
                                   if k != "systolic_mac"},
           "recurrence_backward_launches": backward_launches,
           "recurrence_bf16_launches": bf16_launches,
           "recurrence_bf16_backward_launches": bf16_backward_launches,
           "backend_summary": summary}
    if not all(math.isfinite(x) for x in res.losses):
        fail(f"train {backend}: losses {res.losses}")
    if backend != "ideal":
        if launches != steps * gemms or summary["calls"] != launches:
            fail(f"train {backend}: {launches} systolic_mac launches and "
                 f"{summary['calls']} GEMM calls over {steps} steps; "
                 f"{gemms} a step expected")
        if summary["flags"] != 0:
            fail(f"train {backend}: {summary['flags']} flags at nominal "
                 f"rails")
    elif launches:
        fail(f"train ideal: {launches} systolic_mac launches")
    if opt_cfg.int8_moments:
        del res
        release(torch)
        return row
    api = mods.model_api(cfg)
    step_fn = tmods.make_train_step(api, cfg, opt_cfg)
    batch = train_batch(torch, cfg, tmods, steps)
    with mods.use_backend(be):
        rows = profile_calls(torch, {"step": lambda: step_fn(
            res.final_params, res.final_opt_state, batch)})["step"]
    if rows is not None:
        b1 = [r for r in rows if r["kernel"] == "systolic_mac_kernel"]
        row.update(
            device_ms_per_step=sum(r["ms"] for r in rows),
            kernels_per_step=sum(r["calls"] for r in rows),
            systolic_mac_device_ms_per_step=sum(r["ms"] for r in b1),
            systolic_mac_launches_profiled=sum(r["calls"] for r in b1),
            recurrence_device_ms_per_step={
                r["kernel"]: r["ms"] for r in rows
                if r["kernel"].startswith(("wkv6_", "ssd_"))},
            top_kernels=rows[:8])
    else:
        row.update(device_ms_per_step=None,
                   systolic_mac_device_ms_per_step=None,
                   recurrence_device_ms_per_step=None)
    del res, step_fn, batch
    release(torch)
    return row


def smoke_trainer(torch, mods, tmods):
    """The JAX package's trainer tests at their own smoke sizes, on the
    card, every GEMM on B1 (``reference``): the loss descends over 16 steps
    (phi4-mini smoke) and resumes; 4 steps, an async checkpoint and a
    resume for 2 give the 6 straight steps' losses within rtol 1e-5
    (starcoder2 smoke).  Then whether a step repeated from the same state
    gives the same bits, dense and MoE, on both backends: which leaves
    differ, if any."""
    import tempfile

    from repro_torch.kernels.wkv6 import wkv6
    seq, batch = SMOKE_TRAIN_SHAPE
    shape = mods.ShapeConfig("t", seq, batch, "train")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="train_ckpt_"))
    out = {}
    try:
        with mods.use_backend(mods.get_backend("reference")):
            cfg = mods.get_config(ARCH, smoke=True)
            tc = tmods.TrainConfig(steps=16, log_every=0, checkpoint_every=8,
                                   checkpoint_dir=str(tmp / "descent"),
                                   async_checkpoint=False)
            ocfg = tmods.optim.AdamWConfig(lr=5e-3, warmup_steps=2,
                                           total_steps=16)
            res = tmods.train(cfg, shape, tc, ocfg)
            first, last = (sum(res.losses[:4]) / 4,
                           sum(res.losses[-4:]) / 4)
            res2 = tmods.train(cfg, shape, dataclasses.replace(tc, steps=20),
                               ocfg, resume=True)
            out["descent"] = {"arch": cfg.name, "losses": res.losses,
                              "mean_first_4": first, "mean_last_4": last,
                              "resumed_steps": res2.steps_done}
            if not (all(math.isfinite(x) for x in res.losses)
                    and last < first - 0.05 and res2.steps_done == 4):
                fail(f"smoke trainer: descent {first} -> {last}, resumed "
                     f"{res2.steps_done} steps")
            cfg = mods.get_config("starcoder2-3b", smoke=True)
            ocfg = tmods.optim.AdamWConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=6)
            straight = tmods.train(cfg, shape, tmods.TrainConfig(
                steps=6, log_every=0, checkpoint_every=0), ocfg)
            tmods.train(cfg, shape, tmods.TrainConfig(
                steps=4, log_every=0, checkpoint_every=4,
                checkpoint_dir=str(tmp / "resume")), ocfg)
            part2 = tmods.train(cfg, shape, tmods.TrainConfig(
                steps=6, log_every=0, checkpoint_every=0,
                checkpoint_dir=str(tmp / "resume")), ocfg, resume=True)
            gap = max(abs(a - b) / abs(b) for a, b in zip(
                part2.losses, straight.losses[4:]))
            out["resume"] = {"arch": cfg.name, "straight": straight.losses,
                             "resumed": part2.losses, "max_rel_gap": gap,
                             "bit_equal": part2.losses
                             == straight.losses[4:]}
            if not gap <= 1e-5:
                fail(f"smoke trainer: resumed losses {part2.losses} against "
                     f"{straight.losses[4:]} (rtol 1e-5)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    repeats = []
    for arch in (ARCH, GROK):
        cfg = mods.get_config(arch, smoke=True)
        for backend in ("reference", "ideal"):
            api = mods.model_api(cfg, backend=backend)
            ocfg = tmods.optim.AdamWConfig(lr=1e-3, warmup_steps=1)
            data = tmods.SyntheticDataset(tmods.DataConfig(
                vocab_size=cfg.padded_vocab, seq_len=seq, global_batch=batch,
                seed=SEED)).batch_at(0).data
            b = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
            trees = []
            for _ in range(2):
                params = api.init_params(SEED)
                state = tmods.optim.init_state(params, ocfg)
                tmods.make_train_step(api, cfg, ocfg)(params, state, b)
                trees.append(params)
            names = [n for n, _ in tmods.flatten(trees[0])]
            flat = [dict(tmods.flatten(t)) for t in trees]
            differ = [n for n in names if not torch.equal(
                flat[0][n].view(torch.int16) if flat[0][n].dtype
                == torch.bfloat16 else flat[0][n],
                flat[1][n].view(torch.int16) if flat[1][n].dtype
                == torch.bfloat16 else flat[1][n])]
            repeats.append({"arch": arch, "backend": backend,
                            "bit_equal": not differ,
                            "leaves_that_differ": differ})
    out["repeat_step_bits"] = repeats
    for arch in SSM_ARCHS:
        cfg = mods.get_config(arch, smoke=True)
        with mods.use_backend(mods.get_backend("reference")):
            res = tmods.train(cfg, shape, tmods.TrainConfig(
                steps=1, log_every=0, checkpoint_every=0))
        if not (res.steps_done == 1 and all(math.isfinite(x)
                                            for x in res.losses)):
            fail(f"{arch} smoke training: {res.steps_done} steps, losses "
                 f"{res.losses}")
        out.setdefault("ssm_one_step", {})[arch] = res.losses
        # the bf16 recurrence (rwkv6 on wkv6's bf16 kernels; zamba2 reads
        # no ssm_bf16, and its step is the f32 config's)
        n0 = wkv6.bf16_backward_launches
        with mods.use_backend(mods.get_backend("reference")):
            res_bf = tmods.train(dataclasses.replace(cfg, ssm_bf16=True),
                                 shape, tmods.TrainConfig(
                                     steps=1, log_every=0,
                                     checkpoint_every=0))
        n_bwd = wkv6.bf16_backward_launches - n0
        if not (res_bf.steps_done == 1
                and all(math.isfinite(x) for x in res_bf.losses)):
            fail(f"{arch} ssm_bf16 smoke training: {res_bf.steps_done} "
                 f"steps, losses {res_bf.losses}")
        if n_bwd != (cfg.n_layers if cfg.family == "ssm" else 0):
            fail(f"{arch} ssm_bf16 smoke training: {n_bwd} bf16 wkv6 "
                 f"backward launches")
        out.setdefault("ssm_bf16_one_step", {})[arch] = {
            "losses": res_bf.losses, "wkv6_bf16_backward_launches": n_bwd,
            "bit_equal_to_f32": res_bf.losses == res.losses}
    return out


def train_modules():
    """The trainer's modules the train phases drive."""
    from repro_torch import optim as optim_mod
    from repro_torch.checkpoint.manager import _flatten_with_names
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.optim import adamw
    from repro_torch.runtime import HeartbeatMonitor
    from repro_torch.train import TrainConfig, make_train_step, train
    return types.SimpleNamespace(
        optim=optim_mod, adamw=adamw, DataConfig=DataConfig,
        SyntheticDataset=SyntheticDataset, HeartbeatMonitor=HeartbeatMonitor,
        TrainConfig=TrainConfig, make_train_step=make_train_step,
        train=train, flatten=_flatten_with_names)


def train_phase(torch, cfg, mods, counters):
    """phi4-mini-3.8b at published width and depth through
    ``repro_torch.train.train``: TRAIN_STEPS steps under ``reference`` (B1
    launches = 13 L + 1 a step, 0 flags), the same steps from the same
    seeded state under ``ideal`` (step 0's loss within TOL_TRAIN_LOSS, its
    global gradient norm within TOL_GNORM), TRAIN_INT8_STEPS with int8
    moments; then :func:`smoke_trainer`."""
    tmods = train_modules()
    optim_mod = tmods.optim
    specs = mods.model_api(cfg).param_specs()
    runs = [train_run(torch, cfg, mods, tmods, counters, backend,
                      optim_mod.AdamWConfig(), TRAIN_STEPS)
            for backend in ("reference", "ideal")]
    ref, ideal = runs
    hold_b1_limit("phi4_train_step", ref["systolic_mac_device_ms_per_step"])
    loss_gap = abs(ref["losses"][0] - ideal["losses"][0]) / abs(
        ideal["losses"][0])
    norm_gap = abs(ref["global_grad_norm"][0] - ideal["global_grad_norm"][0]
                   ) / ideal["global_grad_norm"][0]
    if not loss_gap <= TOL_TRAIN_LOSS:
        fail(f"train: step 0's loss {ref['losses'][0]} on reference, "
             f"{ideal['losses'][0]} on ideal (limit {TOL_TRAIN_LOSS})")
    if not norm_gap <= TOL_GNORM:
        fail(f"train: step 0's gradient norm {ref['global_grad_norm'][0]} "
             f"on reference, {ideal['global_grad_norm'][0]} on ideal "
             f"(limit {TOL_GNORM})")
    int8 = train_run(torch, cfg, mods, tmods, counters, "reference",
                     optim_mod.AdamWConfig(int8_moments=True),
                     TRAIN_INT8_STEPS)
    return {"arch": cfg.name, "batch": list(TRAIN_BATCH),
            "parameters": mods.param_count(specs),
            "gemms_per_step": 13 * cfg.n_layers + 1,
            "reference": ref, "ideal": ideal, "int8_moments": int8,
            "step0_loss_gap_rel": loss_gap,
            "step0_loss_gap_limit": TOL_TRAIN_LOSS,
            "step0_grad_norm_gap_rel": norm_gap,
            "step0_grad_norm_gap_limit": TOL_GNORM,
            "smoke": smoke_trainer(torch, mods, tmods)}


def ssm_train_table(cfg):
    """name -> (K, N, launches per train step, transposed view?, dtype) of
    the bf16 GEMMs B1 runs in a rwkv6 / zamba2 train step under
    ``reference`` (:func:`ssm_train_gemms` less rwkv6's f32 ``w_lora_b``):
    the decode step's weights, each recomputed in the backward pass but
    zamba2's ``out_proj`` and shared-block MLP ``w2``."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {name: (k, n, 1 if name == "logits" else 2 * per, t, dt)
                for name, (k, n, per, t, dt) in rwkv6_gemms(cfg).items()
                if dt == "bfloat16"}
    apps = L // cfg.shared_attn_period
    table = zamba2_gemms(cfg)
    per_step = {"in_proj": 2 * L, "out_proj/down": L + 2 * apps,
                "wq/wk/wv/wo": 8 * apps, "w1/wg": 4 * apps, "w2": apps,
                "logits": 1}
    return {name: (k, n, per_step[name], t, dt)
            for name, (k, n, _, t, dt) in table.items()}


def ssm_train_gemms(cfg):
    """B1 launches of one rwkv6 / zamba2 train step under ``reference``
    (``remat="full"``): every forward GEMM, and again in the backward pass
    all of rwkv6's (10 a layer) and all of zamba2's but each Mamba2
    layer's ``out_proj`` and each shared-block application's MLP ``w2``
    (``models/ssm.py``, as the reference's compiled step), plus the
    logits once."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return 2 * 10 * L + 1
    apps = L // cfg.shared_attn_period
    block = 1 + 4 + (3 if cfg.act == "swiglu" else 2)   # down, attn, MLP
    return 3 * L + apps * (2 * block - 1) + 1


#: the train_ssm runs: (arch, cfg.ssm_bf16), each on reference and ideal
SSM_TRAIN_RUNS = (("rwkv6-1.6b", False), ("zamba2-2.7b", False),
                  ("rwkv6-1.6b", True))


def train_ssm(torch, mods, counters):
    """rwkv6-1.6b and zamba2-2.7b at published width and depth through
    ``repro_torch.train.train``, and rwkv6-1.6b again with
    ``ssm_bf16=True`` (the bf16 recurrence: wkv6's bf16 forward and
    backward kernels): TRAIN_STEPS steps of TRAIN_BATCH under
    ``reference`` (B1 on every forward GEMM, :func:`ssm_train_gemms` a
    step, 0 flags), the same seeded steps under ``ideal`` (step 0's loss
    within TOL_TRAIN_LOSS, its global gradient norm within TOL_GNORM, as
    :func:`train_phase` holds phi4).  Each run: seconds a step, tokens/s,
    peak memory, the recurrence's forward launches a step (twice a layer:
    the forward, and again in the backward pass under ``remat="full"``)
    and backward launches (once a layer), all of the run's precision (the
    other's 0), and one profiled step's device time by kernel."""
    tmods = train_modules()
    out = {}
    for arch, bf16 in SSM_TRAIN_RUNS:
        t0 = time.monotonic()
        key = f"{arch} ssm_bf16" if bf16 else arch
        cfg = dataclasses.replace(mods.get_config(arch), ssm_bf16=bf16)
        gemms = ssm_train_gemms(cfg)
        kernel = "wkv6" if cfg.family == "ssm" else "ssd_chunk"
        tag = f"{kernel}_bf16" if bf16 else kernel
        runs = {}
        for backend in ("reference", "ideal"):
            row = train_run(torch, cfg, mods, tmods, counters, backend,
                            tmods.optim.AdamWConfig(), TRAIN_STEPS,
                            gemms=gemms)
            routes = {False: (row["recurrence_launches"],
                              row["recurrence_backward_launches"]),
                      True: (row["recurrence_bf16_launches"],
                             row["recurrence_bf16_backward_launches"])}
            for route, (fwd, bwd) in routes.items():
                on = route == bf16
                want_fwd = {k: (2 * cfg.n_layers * TRAIN_STEPS
                                if on and k == kernel else 0) for k in fwd}
                want_bwd = {k: (cfg.n_layers * TRAIN_STEPS
                                if on and k == kernel else 0) for k in bwd}
                if fwd != want_fwd or bwd != want_bwd:
                    fail(f"train_ssm {key} {backend}: "
                         f"{'bf16' if route else 'f32'} forward launches "
                         f"{fwd}, backward {bwd}; expected {want_fwd}, "
                         f"{want_bwd}")
            fwd, bwd = routes[bf16]
            row.update({f"{tag}_launches_per_step": fwd[kernel]
                        / TRAIN_STEPS,
                        f"{tag}_backward_launches_per_step": bwd[kernel]
                        / TRAIN_STEPS})
            runs[backend] = row
        ref, ideal = runs["reference"], runs["ideal"]
        loss_gap = abs(ref["losses"][0] - ideal["losses"][0]) / abs(
            ideal["losses"][0])
        norm_gap = abs(ref["global_grad_norm"][0]
                       - ideal["global_grad_norm"][0]
                       ) / ideal["global_grad_norm"][0]
        if not loss_gap <= TOL_TRAIN_LOSS:
            fail(f"train_ssm {key}: step 0's loss {ref['losses'][0]} on "
                 f"reference, {ideal['losses'][0]} on ideal (limit "
                 f"{TOL_TRAIN_LOSS})")
        if not norm_gap <= TOL_GNORM:
            fail(f"train_ssm {key}: step 0's gradient norm "
                 f"{ref['global_grad_norm'][0]} on reference, "
                 f"{ideal['global_grad_norm'][0]} on ideal (limit "
                 f"{TOL_GNORM})")
        out[key] = {
            "arch": arch, "ssm_bf16": bf16, "batch": list(TRAIN_BATCH),
            "layers": cfg.n_layers,
            "d_model": cfg.d_model, "cut": None, "remat": cfg.remat,
            "parameters": mods.param_count(mods.model_api(cfg).param_specs()),
            "gemms_per_step": gemms, "reference": ref, "ideal": ideal,
            "step0_loss_gap_rel": loss_gap,
            "step0_loss_gap_limit": TOL_TRAIN_LOSS,
            "step0_grad_norm_gap_rel": norm_gap,
            "step0_grad_norm_gap_limit": TOL_GNORM,
            "seconds": time.monotonic() - t0}
        print(f"train_ssm {key}: {out[key]['seconds']:.1f} s, step "
              f"{ref['step_s_mean_after_first']:.3f} s on reference, peak "
              f"{ref['peak_device_memory_gb']:.1f} GB", flush=True)
        release(torch)
    return out


def tree_digest(torch, tree, flatten):
    """name -> a 128-bit digest of a tree's leaves' bits, on the device: each
    leaf's raw words (int16 for 2-byte dtypes, else int32) summed, and
    summed again weighted by their index mod a prime, in int64 (integer
    sums wrap and do not depend on their order).  Two trees with equal
    digests are bit-equal but for a collision."""
    out = {}
    mult = None
    for name, leaf in flatten(tree):
        t = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        t = t.detach().reshape(-1)
        words = t.view(torch.int16 if t.element_size() == 2 else torch.int32
                       ) if t.element_size() in (2, 4) else t.to(torch.int64)
        plain = weighted = 0
        for i in range(0, words.numel(), 1 << 24):
            w = words[i:i + (1 << 24)].to(torch.int64)
            if mult is None or mult.numel() < w.numel():
                mult = torch.arange(1 << 24, device=w.device,
                                    dtype=torch.int64) % 1000003 + 1
            plain = plain + w.sum()
            weighted = weighted + (w * mult[:w.numel()]).sum()
        out[name] = (int(plain), int(weighted))
    return out


def profiled_b1(rows):
    """B1's device ms and launches among one profiled call's kernel rows
    (:func:`profile_calls`), beside every kernel's; None where the
    profiler gave no rows (not measured)."""
    if rows is None:
        return {"systolic_mac_device_ms": None, "device_ms": None}
    b1 = [r for r in rows if r["kernel"] == "systolic_mac_kernel"]
    return {"systolic_mac_device_ms": sum(r["ms"] for r in b1),
            "systolic_mac_launches": sum(r["calls"] for r in b1),
            "device_ms": sum(r["ms"] for r in rows),
            "kernels": sum(r["calls"] for r in rows)}


def launch_counts(counters):
    """Every counted kernel's launches since the counts were zeroed, under
    the ``kernels`` line's names (``<name>_bwd`` a backward kernel,
    ``<name>_bf16`` wkv6's bf16 variants)."""
    out = dict(counters.read())
    out.update({f"{k}_bwd": v for k, v in counters.read_backward().items()})
    fwd, bwd = counters.read_bf16()
    out.update({f"{k}_bf16": v for k, v in fwd.items()})
    out.update({f"{k}_bwd_bf16": v for k, v in bwd.items()})
    return out


def add_launches(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def expected_launches(counts, **want):
    """``counts``' names with ``want``'s values, 0 elsewhere."""
    return {name: want.get(name, 0) for name in counts}


def mesh_train_launches(cfg):
    """name -> launches of one train step of ``cfg`` on ``reference``: B1
    once a GEMM (13 L + 1 a dense model, :func:`ssm_train_gemms` for rwkv6
    / zamba2, 13 an encoder and 21 a decoder layer + 1 for seamless); a
    recurrence's forward twice a layer (again in the backward pass under
    ``remat="full"``) and its backward once, in the run's precision."""
    L = cfg.n_layers
    want = {}
    if cfg.family in ("ssm", "hybrid"):
        want["systolic_mac"] = ssm_train_gemms(cfg)
        kernel = "wkv6" if cfg.family == "ssm" else "ssd_chunk"
        tag = "_bf16" if cfg.ssm_bf16 and kernel == "wkv6" else ""
        want[kernel + tag] = 2 * L
        want[kernel + "_bwd" + tag] = L
    elif cfg.family == "encdec":
        want["systolic_mac"] = 13 * cfg.n_enc_layers + 21 * L + 1
    else:
        want["systolic_mac"] = 13 * L + 1
    return want


def decode_launches(cfg):
    """name -> launches of one decode step of ``cfg`` on ``reference``: B1
    once a GEMM, and rwkv6's one-token ``wkv6`` once a layer."""
    table = {"ssm": rwkv6_gemms, "hybrid": zamba2_gemms,
             "dense": dense_gemms}.get(cfg.family)
    want = {"systolic_mac": family_gemms(cfg)[1] if table is None else sum(
        n for _, _, n, _, _ in table(cfg).values())}
    if cfg.family == "ssm":
        want["wkv6"] = cfg.n_layers
    return want


def profiled_kernels(rows, top=8):
    """:func:`profiled_b1`'s figures, and the device ms of the ``top``
    kernels and of every recurrence kernel, by name."""
    out = profiled_b1(rows)
    if rows is not None:
        out["by_kernel"] = {
            r["kernel"]: r["ms"] for i, r in enumerate(rows)
            if i < top or r["kernel"].startswith(("wkv6_", "ssd_"))}
    return out


def digests_differ(torch, flatten, a, b):
    """The leaves of two trees whose bits differ (:func:`tree_digest`),
    and the number compared."""
    da, db = tree_digest(torch, a, flatten), tree_digest(torch, b, flatten)
    differ = [k for k in da if da[k] != db.get(k)]
    if len(da) != len(db):
        differ.append(f"{len(da)} leaves against {len(db)}")
    return differ, len(da)


def mesh_train(torch, mods, counters, mesh, arch, overrides=None):
    """One train step of ``arch`` at published width and depth
    (``overrides`` on its config) on ``reference`` through ``build_cell``'s
    rules on the one-rank mesh, beside the same step with ``rules=None``,
    from the same seeded parameters and the trainer's TRAIN_BATCH batch:
    loss, gradient norm and every updated leaf bit-equal (one rank shards
    nothing; leaves by :func:`tree_digest`), every kernel's launches as
    :func:`mesh_train_launches` counts them on both sides; a second step of
    each timed, and a third profiled by kernel.  The two runs are made one
    after the other, with :func:`release` between them: one optimizer
    state at a time.  Returns (the row, the mesh side's launches)."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.shardlib import distribute_tree
    tmods = train_modules()
    ocfg = tmods.optim.AdamWConfig()
    shape = mods.ShapeConfig("train", TRAIN_BATCH[1], TRAIN_BATCH[0],
                             "train")
    cell = build_cell(arch, shape, mesh, overrides=overrides, opt_cfg=ocfg)
    cfg = cell.cfg
    api = mods.model_api(cfg)
    batch = train_batch(torch, cfg, tmods, 0)
    want = mesh_train_launches(cfg)
    runs = {}
    for label, rules in (("rules_none", None), ("mesh", cell.rules)):
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        params = api.init_params(SEED)
        state = tmods.optim.init_state(params, ocfg)
        if rules is not None:
            params = distribute_tree(params, api.param_specs(), rules)
            state = distribute_tree(
                state, tmods.optim.state_specs(api.param_specs(), ocfg),
                rules)
        step = cell.fn if rules is not None else tmods.make_train_step(
            api, cfg, ocfg)
        norms, spans = [], []
        be = mods.get_backend("reference")
        torch.cuda.synchronize()
        seconds, losses = [], []
        with mods.use_backend(be), recording_optimizer(
                torch, tmods.optim, tmods.adamw, norms, spans):
            for i in range(2):
                if i == 0:
                    counters.zero()
                t1 = time.monotonic()
                _, state, loss = step(params, state, batch)
                losses.append(float(loss))
                seconds.append(time.monotonic() - t1)
                if i == 0:
                    launches = launch_counts(counters)
                    digest = tree_digest(
                        torch, {"params": params, "opt": state},
                        tmods.flatten)
        norms, opt_s = read_recorded(torch, norms, spans)
        summary = be.summary()
        # the device time by kernel inside one more step (torch.profiler)
        with mods.use_backend(mods.get_backend("reference")):
            prof = profile_calls(torch, {"step": lambda: step(
                params, state, batch)})["step"]
        runs[label] = {"loss": losses[0], "global_grad_norm": norms[0],
                       "step_s": seconds, "optimizer_stream_s": opt_s,
                       "systolic_mac_launches_step0": launches[
                           "systolic_mac"],
                       "launches_step0": launches,
                       "backend_calls": summary["calls"],
                       "flags": summary["flags"], "digest": digest,
                       "peak_device_memory_gb":
                           torch.cuda.max_memory_allocated() / 1e9,
                       "profiled_step": profiled_kernels(prof)}
        if launches != expected_launches(launches, **want):
            fail(f"mesh train {cfg.name} ({label}): launches {launches} in "
                 f"a step; expected {want}")
        del params, state, step
    release(torch)
    none, on_mesh = runs["rules_none"], runs["mesh"]
    differ = [k for k in none["digest"]
              if none["digest"][k] != on_mesh["digest"].get(k)]
    bits = (none["loss"] == on_mesh["loss"]
            and none["global_grad_norm"] == on_mesh["global_grad_norm"]
            and not differ and len(none["digest"]) == len(
                on_mesh["digest"]))
    row = {"arch": cfg.name, "overrides": overrides or {},
           "batch": list(TRAIN_BATCH), "layers": cfg.n_layers,
           "backend": "reference", "gemms_per_step": want["systolic_mac"],
           "launches_per_step": want,
           "rules_none": {k: v for k, v in none.items() if k != "digest"},
           "mesh": {k: v for k, v in on_mesh.items() if k != "digest"},
           "leaves_compared": len(none["digest"]),
           "leaves_that_differ": differ, "bit_equal": bits,
           "step_s_second": {"rules_none": none["step_s"][1],
                             "mesh": on_mesh["step_s"][1]}}
    if not bits:
        fail(f"mesh train step of {cfg.name} not bit-equal to rules=None: "
             f"loss {on_mesh['loss']} / {none['loss']}, norm "
             f"{on_mesh['global_grad_norm']} / {none['global_grad_norm']}, "
             f"leaves {differ[:8]}")
    print(f"mesh: {cfg.name} {overrides or ''} train step "
          f"{on_mesh['step_s'][1]:.3f} s on the mesh beside "
          f"{none['step_s'][1]:.3f} s with rules=None", flush=True)
    return row, on_mesh["launches_step0"]


def mesh_prefill(torch, mods, counters, api, pcell, params, dparams, batch,
                 max_len):
    """One ``reference`` prefill of ``batch`` on the mesh (``pcell``)
    beside ``api.prefill``: logits and every leaf of the state bit-equal,
    B1 launches = the prefill's GEMMs (:func:`family_gemms`) and nothing
    else; seconds of each, and one more of each profiled by kernel.
    Returns (the row, the mesh side's launches, the two states, the
    greedy tokens)."""
    from repro_torch.checkpoint.manager import _flatten_with_names
    be = mods.get_backend("reference")
    with mods.use_backend(be):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        want, plain_state = api.prefill(params, batch, max_len=max_len)
        torch.cuda.synchronize()
        plain_s = time.monotonic() - t1
        counters.zero()
        t1 = time.monotonic()
        got, mesh_state = pcell.fn(dparams, batch)
        got = got.full_tensor()
        torch.cuda.synchronize()
        mesh_s = time.monotonic() - t1
        launches = launch_counts(counters)
    per_call = {"systolic_mac": family_gemms(api.cfg)[0]}
    differ, compared = digests_differ(torch, _flatten_with_names,
                                      plain_state, mesh_state)
    row = {"rows": int(want.shape[0]), "max_len": max_len,
           "positions": int(plain_state["index"][0]),
           "logits_bit_equal": bool(torch.equal(want, got)),
           "state_leaves_compared": compared,
           "state_leaves_that_differ": differ, "launches": launches,
           "gemms": per_call["systolic_mac"],
           "prefill_s": {"rules_none": plain_s, "mesh": mesh_s}}
    if not row["logits_bit_equal"] or differ:
        fail(f"mesh prefill of {api.cfg.name}: logits equal "
             f"{row['logits_bit_equal']}, state leaves that differ "
             f"{differ[:8]}")
    if launches != expected_launches(launches, **per_call):
        fail(f"mesh prefill of {api.cfg.name}: launches {launches}; "
             f"expected {per_call}")
    with mods.use_backend(mods.get_backend("reference")):
        prof = profile_calls(torch, {
            "rules_none": lambda: api.prefill(params, batch,
                                              max_len=max_len),
            "mesh": lambda: pcell.fn(dparams, batch)})
    row["profiled"] = {k: profiled_kernels(v) for k, v in prof.items()}
    tok = want.argmax(-1, keepdim=True).to(torch.int32)
    return row, launches, plain_state, mesh_state, tok


def mesh_decode(torch, mods, counters, api, dcell, params, dparams,
                plain_state, mesh_state, tok):
    """MESH_DECODE_STEPS ``reference`` decode steps on the mesh
    (``dcell``) beside ``api.decode_step`` (what ServeEngine runs), the
    unsharded step's greedy tokens fed to both: logits bit-equal at every
    step and every leaf of the final states, launches as
    :func:`decode_launches` counts them a step; each step's seconds, and
    one more step of each profiled by kernel.  Returns (the row, the mesh
    side's launches)."""
    from repro_torch.checkpoint.manager import _flatten_with_names
    per_step = decode_launches(api.cfg)
    steps_out, total, mesh_s, plain_s = [], {}, [], []
    with mods.use_backend(mods.get_backend("reference")):
        for _ in range(MESH_DECODE_STEPS):
            torch.cuda.synchronize()
            t1 = time.monotonic()
            want, plain_state = api.decode_step(params, plain_state, tok)
            torch.cuda.synchronize()
            plain_s.append(time.monotonic() - t1)
            counters.zero()
            t1 = time.monotonic()
            got, mesh_state = dcell.fn(dparams, mesh_state, tok)
            got = got.full_tensor()
            torch.cuda.synchronize()
            mesh_s.append(time.monotonic() - t1)
            launches = launch_counts(counters)
            add_launches(total, launches)
            same = torch.equal(want, got)
            nxt = want.argmax(-1, keepdim=True).to(torch.int32)
            steps_out.append({"logits_bit_equal": bool(same),
                              "tokens": nxt[:, 0].tolist(),
                              "tokens_mesh": got.argmax(-1).tolist()})
            if not same:
                fail(f"mesh decode of {api.cfg.name}, step "
                     f"{len(steps_out)}: logits differ from the unsharded "
                     f"step's")
            if launches != expected_launches(launches, **per_step):
                fail(f"mesh decode of {api.cfg.name}: launches {launches} "
                     f"in a step; expected {per_step}")
            tok = nxt
    differ, compared = digests_differ(torch, _flatten_with_names,
                                      plain_state, mesh_state)
    if differ:
        fail(f"mesh decode of {api.cfg.name}: state leaves that differ "
             f"{differ[:8]}")
    with mods.use_backend(mods.get_backend("reference")):
        prof = profile_calls(torch, {
            "rules_none": lambda: api.decode_step(params, plain_state, tok),
            "mesh": lambda: dcell.fn(dparams, mesh_state, tok)})
    return {"arch": api.cfg.name, "rows": int(tok.shape[0]),
            "steps": steps_out, "launches": total,
            "launches_per_step": per_step,
            "gemms_per_step": per_step["systolic_mac"],
            "state_leaves_compared": compared,
            "state_leaves_that_differ": differ,
            "step_s_mesh": mesh_s, "step_s_rules_none": plain_s,
            "profiled_step": {k: profiled_kernels(v)
                              for k, v in prof.items()}}, total


def mesh_serving(torch, mods, counters, mesh, arch, cfg, prompt=None,
                 max_len=MAX_LEN, rows=SLOTS, seed=SEED + 24):
    """``cfg`` (``arch`` at published width, its depth cut where the card
    cannot hold it) served on the one-rank mesh beside no mesh, from
    ``init_params(SEED)``: a prefill of ``prompt`` (:func:`mesh_prefill`;
    none: a fresh decode state and seeded tokens), then
    :func:`mesh_decode`'s steps.  Returns (the row, the mesh side's
    launches); the weights are freed."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.shardlib import distribute_tree
    overrides = ({"n_layers": cfg.n_layers}
                 if cfg.n_layers != mods.get_config(arch).n_layers else None)
    api = mods.model_api(cfg)
    params = api.init_params(SEED)
    dshape = mods.ShapeConfig("serve", max_len, rows, "decode")
    dcell = build_cell(arch, dshape, mesh, overrides=overrides)
    dparams = distribute_tree(params, api.param_specs(), dcell.rules)
    row, total = {"arch": cfg.name, "layers": cfg.n_layers}, {}
    if prompt is not None:
        pcell = build_cell(arch, mods.ShapeConfig("prefill", max_len, rows,
                                                  "prefill"),
                           mesh, overrides=overrides)
        row["prefill"], launches, plain_state, mesh_state, tok = \
            mesh_prefill(torch, mods, counters, api, pcell, params, dparams,
                         prompt, max_len)
        add_launches(total, launches)
    else:
        plain_state = api.make_decode_state(dshape)
        mesh_state = distribute_tree(api.make_decode_state(dshape),
                                     api.decode_state_specs(dshape),
                                     dcell.rules)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        tok = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                            dtype=torch.int32).to(DEVICE)
    row["decode"], launches = mesh_decode(
        torch, mods, counters, api, dcell, params, dparams, plain_state,
        mesh_state, tok)
    add_launches(total, launches)
    del params, dparams, plain_state, mesh_state
    release(torch)
    print(f"mesh: {cfg.name} decode step {row['decode']['step_s_mesh'][-1]:.3f}"
          f" s on the mesh beside {row['decode']['step_s_rules_none'][-1]:.3f}"
          f" s with rules=None", flush=True)
    return row, total


#: (e) the recurrences' train steps on the mesh: (arch, overrides)
MESH_SSM_TRAIN = (("rwkv6-1.6b", None), ("zamba2-2.7b", None),
                  ("rwkv6-1.6b", {"ssm_bf16": True}))


def mesh_phase(torch, cfg, mods, counters):
    """The device mesh on the card: a one-rank ``nccl`` group and a (1, 1)
    ("data", "model") mesh (``launch.mesh.start_mesh``); every run on
    ``reference`` through ``build_cell``'s rules beside the same work with
    ``rules=None`` (one rank shards nothing: bit-equal), one after the
    other with :func:`release` between them, each family's weights freed
    before the next.  (b) One phi4-mini train step at full width
    (:func:`mesh_train`: loss, gradient norm and every updated leaf
    bit-equal, B1 launches = the step's 13 L + 1 GEMMs; a second step of
    each timed, a third profiled).  (c) MESH_DECODE_STEPS decode steps of
    the served phi4 (SLOTS rows; :func:`mesh_serving`): logits, tokens and
    the final state bit-equal, B1 launches = 225 a step, one more step of
    each profiled.  (e) One train step of TRAIN_BATCH each of rwkv6-1.6b,
    zamba2-2.7b and rwkv6-1.6b with ``ssm_bf16=True``: the recurrences
    through ``local_map`` forward twice and backward once a layer (wkv6 /
    ssd_chunk and wkv6_bwd / ssd_chunk_bwd; the bf16 run wkv6_bf16 and
    wkv6_bwd_bf16 only), B1 481 / 298 a step; then MESH_DECODE_STEPS decode
    steps of rwkv6 (the one-token wkv6 24 a step) and zamba2.  (f)
    seamless-m4t-medium: a prefill with seeded frames, MESH_DECODE_STEPS
    decode steps, one train step of TRAIN_BATCH.  (g) llava-next-mistral-7b:
    the prefill of FRONTEND patches + VLM_PROMPT tokens (B1 at M = 2944,
    the wide form) and MESH_DECODE_STEPS decode steps; llama4-scout at 8 of
    its 48 layers: the same decode steps.  Every run: B1 launches = its
    GEMMs, seconds beside ``rules=None`` and the device ms by kernel of one
    profiled step.  (d) The dry run of DRYRUN_CELL as a child process (one
    process holds one default group): ``status: ok``, flops > 0,
    collectives > 0, its trace seconds.  Returns (the line, the mesh
    side's launches by kernel)."""
    from repro_torch.launch import mesh as mesh_mod
    out = {"held_on_the_cpu": "4 gloo ranks, (2, 2) meshes, one process a "
                              "rank: serving of every family bit-equal to "
                              "no mesh on reference (tests/test_torch_mesh"
                              ".py, test_torch_mesh_serve_families.py); a "
                              "train step of every family within the train "
                              "tests' tolerances of no mesh, phi4's, grok's "
                              "and seamless's also of the JAX package's "
                              "4-device mesh (test_torch_mesh.py, "
                              "test_torch_mesh_train_families.py, "
                              "test_torch_mesh_families.py); moe_ep_a2a "
                              "against the JAX package's mesh "
                              "(test_torch_mesh.py)",
           "not_run_on_the_card": "a mesh of more than one rank (the host "
                                  "has one GPU and NCCL refuses two ranks "
                                  "on one GPU) and so moe_ep_a2a, which "
                                  "needs n_experts ranks on the expert "
                                  "axis"}
    emit("mesh_note", out)
    out = {}
    total = {}
    t0 = time.monotonic()
    mesh = mesh_mod.start_mesh((1, 1), ("data", "model"))
    try:
        out["start_mesh_s"] = time.monotonic() - t0
        out["mesh"] = {"shape": list(mesh.mesh.shape),
                       "axes": list(mesh.mesh_dim_names),
                       "backend": torch.distributed.get_backend(),
                       "device_type": mesh.device_type}
        # (b) phi4-mini's train step, (c) the served phi4's decode steps
        out["train"], launches = mesh_train(torch, mods, counters, mesh,
                                            ARCH)
        add_launches(total, launches)
        out["decode"], launches = mesh_serving(torch, mods, counters, mesh,
                                               ARCH, cfg)
        add_launches(total, launches)
        # (e) the recurrences: train steps, then decode steps
        out["ssm_train"] = []
        for arch, overrides in MESH_SSM_TRAIN:
            row, launches = mesh_train(torch, mods, counters, mesh, arch,
                                       overrides)
            out["ssm_train"].append(row)
            add_launches(total, launches)
        out["ssm_decode"] = []
        for arch in SSM_ARCHS:
            row, launches = mesh_serving(torch, mods, counters, mesh, arch,
                                         mods.get_config(arch))
            out["ssm_decode"].append(row)
            add_launches(total, launches)
        # (f) seamless: prefill with seeded frames, decode, train
        arch = "seamless-m4t-medium"
        scfg = mods.get_config(arch)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
        prompt = {"tokens": torch.randint(3, scfg.vocab_size,
                                          (SLOTS, MESH_PROMPT),
                                          generator=gen, device=DEVICE),
                  "frames": torch.randn(
                      (SLOTS, MAX_LEN // scfg.enc_frames_ratio,
                       scfg.d_model), generator=gen,
                      device=DEVICE).to(torch.bfloat16)}
        row, launches = mesh_serving(torch, mods, counters, mesh, arch, scfg,
                                     prompt)
        add_launches(total, launches)
        row["train"], launches = mesh_train(torch, mods, counters, mesh,
                                            arch)
        add_launches(total, launches)
        out["encdec"] = row
        # (g) llava's patch prefill and decode; llama4 (8 layers) decode
        arch = "llava-next-mistral-7b"
        vcfg = mods.get_config(arch)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 32)
        prompt = {"patch_embeds": torch.randn(
                      (1, vcfg.frontend_tokens, vcfg.d_model), generator=gen,
                      device=DEVICE).to(torch.bfloat16),
                  "tokens": torch.randint(3, vcfg.vocab_size,
                                          (1, VLM_PROMPT), generator=gen,
                                          device=DEVICE)}
        out["vlm"], launches = mesh_serving(
            torch, mods, counters, mesh, arch, vcfg, prompt,
            max_len=vcfg.frontend_tokens + VLM_PROMPT + MESH_DECODE_STEPS,
            rows=1)
        add_launches(total, launches)
        arch = "llama4-scout-17b-a16e"
        out["moe"], launches = mesh_serving(
            torch, mods, counters, mesh, arch,
            family_config(mods.get_config, arch))
        add_launches(total, launches)
    finally:
        mesh_mod.stop_mesh()
    release(torch)

    # (d) the dry run in a child process: a fake group of 256 ranks
    arch, shape_name = DRYRUN_CELL
    out_dir = ROOT / "build" / "dryrun"
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.monotonic()
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape_name, "--out-dir", str(out_dir)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.monotonic() - t0
    path = out_dir / f"{arch}_{shape_name}_pod_16x16.json"
    if done.returncode != 0 or not path.exists():
        fail(f"dry run of {arch} x {shape_name} exited {done.returncode}: "
             f"{done.stderr[-2000:]}")
    rec = json.loads(path.read_text())
    n_colls = sum(v["count"] for v in rec.get("collectives", {}).values())
    out["dryrun"] = {"record": rec, "child_wall_s": wall,
                     "collectives": n_colls}
    if not (rec["status"] == "ok" and rec["cost"]["flops"] > 0
            and n_colls > 0):
        fail(f"dry run of {arch} x {shape_name}: {rec.get('status')}, "
             f"{rec.get('error')}")
    print(f"mesh: dry run {arch} x {shape_name} x pod_16x16 trace_s "
          f"{rec['trace_s']}", flush=True)
    for what, prof in (("train", {k: out["train"][k]["profiled_step"]
                                  for k in ("rules_none", "mesh")}),
                       ("decode", out["decode"]["decode"]["profiled_step"])):
        print(f"mesh: B1 device ms in a profiled {what} step, rules=None / "
              f"mesh: {prof['rules_none']['systolic_mac_device_ms']} / "
              f"{prof['mesh']['systolic_mac_device_ms']}", flush=True)
    print(f"mesh: launches on the mesh {total}", flush=True)
    return out, total


def train_entry(shapes, trained, arch=ARCH):
    """B1 over a train step's GEMMs at M = TRAIN_M (phi4-mini's 13 L + 1,
    :func:`ssm_train_table`'s for rwkv6 / zamba2), from the per-shape
    measurements, beside the step's own profile."""
    rows = [s for s in shapes if s.get("M") == TRAIN_M
            and s.get("arch") == arch and "launches_per_model_step" in s]

    def total(key):
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(v * r["launches_per_model_step"]
                   for v, r in zip(vals, rows))
    share = {}
    for r in rows:
        share[r["bound_by"]] = share.get(r["bound_by"], 0.0) + (
            r["bound_ms"] * r["launches_per_model_step"])
    ref = trained["reference"]
    return {"M": TRAIN_M,
            "gemms": sum(r["launches_per_model_step"] for r in rows),
            "timed": "each weight's launches in one reference train step "
                     "(forward, and the block heads again in the backward "
                     "pass), bf16, each weight cold in L2, summed",
            "ms": total("kernel_ms"), "device_ms": total("device_ms"),
            "plain_ms": total("plain_ms"), "library_ms": total("library_ms"),
            "library_device_ms": total("library_device_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(share, key=share.get),
            "bound_by_shape": {r["weight"]: r["bound_by"] for r in rows},
            "device_ms_in_the_step": ref.get(
                "systolic_mac_device_ms_per_step"),
            "launches_per_step": ref["systolic_mac_launches_per_step"]}


def recurrence_entry(name, source, replaces, rows, timed_case, launches,
                     per_step, timed):
    """A recurrence kernel's entry of the ``kernels`` line: the timed row
    (times ``per_step`` launches) and the largest error of any row beside
    its limit."""
    worst = max(rows, key=lambda r: max(r["max_err_y"] / r["max_err_y_limit"],
                                        r["max_err_state"]
                                        / r["max_err_state_limit"]))
    tag = ("y" if worst["max_err_y"] / worst["max_err_y_limit"]
           >= worst["max_err_state"] / worst["max_err_state_limit"]
           else "state")
    row = timed_case
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": worst[f"max_err_{tag}"],
        "max_err_limit": worst[f"max_err_{tag}_limit"],
        "max_err_of": f"{tag}, {worst['case']} (b, s) = "
                      f"{(worst['b'], worst['s'])}",
        "timed": timed,
        "ms": per_step * row["kernel_ms"],
        "plain_ms": per_step * row["plain_ms"],
        "bound_ms": per_step * row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        "library": f"none: no single PyTorch call computes {name}"}


def path_entry(name, source, replaces, rows, launches, err_key):
    """A kernel's entry of the ``kernels`` line: one call at each of the
    model's weight shapes at M = 256, bf16, summed; the largest error of
    any check beside its limit."""
    timed = [r for r in rows if "kernel_ms" in r and r["dtype"] == "bfloat16"]
    # each call's bound is its own larger time; the sum is named by the kind
    # that sets the larger part of it, and each shape's kind is listed
    share = {}
    for r in timed:
        share[r["bound_by"]] = share.get(r["bound_by"], 0.0) + r["bound_ms"]
    checked = [r for r in rows if err_key in r]
    worst = max(checked, key=lambda r: r[err_key] / r["max_err_limit"])
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": worst[err_key], "max_err_limit": worst["max_err_limit"],
        "integer_cells": "bit-equal to the plain version",
        "timed": f"one call at each of the {len(timed)} weight shapes, "
                 f"M={CHUNK_M}, bf16, each weight cold in L2, summed",
        "ms": sum(r["kernel_ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": max(share, key=share.get),
        "bound_by_shape": {r["weight"]: r["bound_by"] for r in timed},
        "library_ms": sum(r["library_ms"] for r in timed),
        "library": f"{timed[0]['library']}; no single PyTorch call computes "
                   f"{name}"}
    if "device_ms" in timed[0]:
        dev = [r["device_ms"] for r in timed]
        entry["device_ms"] = None if None in dev else sum(dev)
        entry["device_ms_by_shape"] = {r["weight"]: r["device_ms"]
                                       for r in timed}
        lib = [r.get("library_device_ms") for r in timed]
        entry["library_device_ms"] = None if None in lib else sum(lib)
        entry["device_ms_of"] = ("the same calls, device time by "
                                 "torch.profiler (ms above: back to back by "
                                 "CUDA events)")
    host = [r for r in timed if "host_us_per_call" in r]
    if host:
        entry["host_us_per_call"] = host[0]["host_us_per_call"]
        entry["library_host_us_per_call"] = host[0].get(
            "library_host_us_per_call")
        entry["host_us_ratio_to_library"] = host[0].get(
            "host_us_ratio_to_library")
    return entry


def main() -> int:
    t_start = time.monotonic()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    sys.path.insert(0, str(SRC))
    # the plain versions' f32 products in full f32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.backend import get_backend, use_backend
    from repro_torch.backend.base import largest_common_block
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.examples import precision_islands as islands
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.precision_island import (precision_island,
                                                      precision_island_plain,
                                                      release_workspaces)
    from repro_torch.kernels.quant_rows import quant_rows
    from repro_torch.kernels.razor_matmul import (razor_matmul,
                                                  razor_matmul_plain)
    from repro_torch import backend as backend_mod
    from repro_torch.kernels.systolic_mac import (WIDE_FROM_M, launch_rows,
                                                  systolic_mac,
                                                  systolic_mac_plain)
    from repro_torch.kernels import abft as abft_mod
    from repro_torch.kernels.tuning import select_blocks
    from repro_torch.kernels.ssd_chunk import (ssd_chunk,
                                               ssd_chunk_backward_plain,
                                               ssd_chunk_plain)
    from repro_torch.kernels.wkv6 import (wkv6, wkv6_backward_plain,
                                          wkv6_plain)
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import model_api, param_count
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serve import ServeEngine
    from repro_torch import flow as tflow
    from repro_torch import hwloop as thw
    from repro_torch.backend import SimulatedBackend
    from repro_torch.hwloop import tiled
    from repro_torch.resilience import GuardedBackend
    import numpy as np

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    emit("env", {"python": sys.version.split()[0],
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "nvcc": nvcc.strip().splitlines()[-2:],
                 "gpu": smi, "device": torch.cuda.get_device_name(0)})

    _build.load_library()
    print(_build.build_log(), file=sys.stderr, flush=True)
    emit("build", {"seconds": _build.build_seconds(),
                   "sources": [str(s.relative_to(ROOT))
                               for s in _build.sources()]})

    cfg = get_config(ARCH)
    shapes = check_serving_shapes(torch, ARCH, dense_gemms(cfg), systolic_mac,
                                  systolic_mac_plain, largest_common_block)
    shapes += check_faulting(torch, systolic_mac, systolic_mac_plain)
    for arch in SSM_ARCHS:      # M = 1..4: a prompt's token, or the slots
        shapes += check_serving_shapes(
            torch, arch, SSM_GEMMS[arch](get_config(arch)), systolic_mac,
            systolic_mac_plain, largest_common_block, ms=range(1, 5), timed_ms=(DECODE_M,))
    family_tables = {
        arch: FAMILY_GEMMS[c.family](c) for arch, c in (
            (x, family_config(get_config, x)) for x in FAMILY_ARCHS)}
    grok = get_config(GROK)
    family_tables[GROK] = {"router (f32)": (grok.d_model, grok.n_experts,
                                            grok.n_layers, False, "float32")}
    for arch, table in family_tables.items():
        shapes += check_serving_shapes(
            torch, arch, table, systolic_mac, systolic_mac_plain,
            largest_common_block,
            timed_ms=(DECODE_M,) if arch != GROK else ())
    # the row counts of the new paths past a prompt's: seamless's frames
    # (served, and in the loss) and loss chunks, llama4's loss chunks and
    # llava's prefill (patches and prompt; its logits take the last row)
    seamless = family_config(get_config, FAMILY_ARCHS[0])
    t_serve, t_loss = (MAX_LEN // seamless.enc_frames_ratio,
                       FRONTEND_LOSS[1] // seamless.enc_frames_ratio)
    llava = family_config(get_config, FAMILY_ARCHS[2])
    long_ms = {FAMILY_ARCHS[0]: (t_serve, t_loss, FRONTEND_LOSS[1]),
               FAMILY_ARCHS[1]: (FRONTEND_LOSS[1],),
               FAMILY_ARCHS[2]: (llava.frontend_tokens + VLM_PROMPT,)}
    for arch, ms in long_ms.items():
        table = {name: w for name, w in family_tables[arch].items()
                 if not (arch == FAMILY_ARCHS[2] and name == "logits")}
        shapes += check_serving_shapes(
            torch, arch, table, systolic_mac, systolic_mac_plain,
            largest_common_block, ms=ms, timed_ms=())
    # a phi4-mini train step's GEMMs: every weight and the logits at the
    # step's rows (TRAIN_M), timed with the step's launch counts; and the
    # rwkv6 / zamba2 train steps' bf16 GEMMs alike
    shapes += check_serving_shapes(
        torch, ARCH, train_gemms(cfg), systolic_mac, systolic_mac_plain,
        largest_common_block, ms=(TRAIN_M,), timed_ms=(TRAIN_M,))
    for arch in SSM_ARCHS:
        shapes += check_serving_shapes(
            torch, arch, ssm_train_table(get_config(arch)), systolic_mac,
            systolic_mac_plain, largest_common_block, ms=(TRAIN_M,),
            timed_ms=(TRAIN_M,))
    # every model weight's (K, N, transposed view?); phi4-mini's w2 also at
    # M = 64 and 256
    model_shapes = {}
    for arch, table in ((ARCH, dense_gemms(cfg)),
                        *((x, SSM_GEMMS[x](get_config(x)))
                          for x in SSM_ARCHS),
                        *family_tables.items()):
        for name, (k, n, _, transposed, _) in table.items():
            key = (k, n, transposed)
            model_shapes[key] = model_shapes.get(key, False) or (
                arch == ARCH and name == "w2")
    invariance_rows = check_row_invariance(torch, systolic_mac, model_shapes)
    # the wide form against the 16-row form: every bf16 weight of llava's
    # prefill and of the phi4 / rwkv6 / zamba2 train steps, both layouts
    wide_shapes = {}
    for table in ({name: w for name, w in family_tables[FAMILY_ARCHS[2]]
                   .items() if name != "logits"}, train_gemms(cfg),
                  *(SSM_GEMMS[x](get_config(x)) for x in SSM_ARCHS)):
        for k, n, _, transposed, dname in table.values():
            if dname == "bfloat16":
                wide_shapes[(k, n, transposed)] = True
    t0 = time.monotonic()
    wide_rows = check_wide_rows(torch, systolic_mac, launch_rows,
                                wide_shapes)
    print(f"wide-form bit checks: {len(wide_rows)} calls, "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    ragged_rows = check_ragged(torch, systolic_mac, systolic_mac_plain,
                               launch_rows)
    wkv6_rows = check_wkv6(torch, wkv6, wkv6_plain)
    ssd_rows = check_ssd(torch, ssd_chunk, ssd_chunk_plain)
    t0 = time.monotonic()
    wkv6_bwd_rows = check_wkv6_bwd(torch, wkv6, wkv6_backward_plain)
    wkv6_bwd_bf16_rows = check_wkv6_bwd_bf16(torch, wkv6,
                                             wkv6_backward_plain)
    ssd_bwd_rows = check_ssd_bwd(torch, ssd_chunk, ssd_chunk_backward_plain)
    print(f"backward kernel checks: {time.monotonic() - t0:.1f} s",
          flush=True)
    razor_rows = check_razor(
        torch, cfg, (razor_matmul, razor_matmul_plain, quant_rows), ref,
        select_blocks)
    island_rows = check_precision_island(
        torch, cfg, (precision_island, precision_island_plain))
    emit("kernel_checks", {"systolic_mac": shapes,
                           "systolic_mac_row_invariance": invariance_rows,
                           "systolic_mac_ragged": ragged_rows,
                           "systolic_mac_wide_rows": wide_rows,
                           "razor_matmul": razor_rows,
                           "precision_island": island_rows,
                           "wkv6": wkv6_rows, "ssd_chunk": ssd_rows,
                           "wkv6_bwd": wkv6_bwd_rows,
                           "wkv6_bwd_bf16": wkv6_bwd_bf16_rows,
                           "ssd_chunk_bwd": ssd_bwd_rows})

    host = host_cost(torch, systolic_mac, backend_mod, largest_common_block)
    emit("host_cost", host)

    # where one call's time goes, at the widest weight (w1/wg), bf16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    a = torch.randn((CHUNK_M, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    b = (torch.randn((cfg.d_model, cfg.d_ff), generator=gen, device="cuda")
         / math.sqrt(cfg.d_model)).to(torch.bfloat16)
    tiers = island_tiers(torch, CHUNK_M // ISLAND_BLOCK,
                         cfg.d_ff // ISLAND_BLOCK, "cuda")
    emit("kernel_profile", {
        "M": CHUNK_M, "K": cfg.d_model, "N": cfg.d_ff, "dtype": "bfloat16",
        **profile_calls(torch, {
            "razor_matmul": lambda: razor_matmul(a, b, tol=ISLAND_TOL),
            "precision_island": lambda: precision_island(a, b, tiers)})})
    del a, b, tiers

    emit("paper_flow", paper_flow(torch, cfg, ops, systolic_mac_plain))

    (n_razor, n_island), island_runs = precision_islands(
        torch, cfg, islands, (razor_matmul, razor_matmul_plain),
        (precision_island, precision_island_plain), select_blocks)
    emit("precision_islands", {"runs": island_runs,
                               "razor_matmul_launches": n_razor,
                               "precision_island_launches": n_island})
    if n_razor <= 0 or n_island <= 0:
        fail(f"the precision-island path launched razor_matmul {n_razor} and "
             f"precision_island {n_island} times")
    # the served phases' peak memory holds no precision_island workspace
    release_workspaces()

    emit("hwloop_checks", hwloop_checks(torch, np, tflow, thw,
                                        SimulatedBackend, tiled))

    abft_rows, verdict_rows, abft_verdict_rows, abft_timed = check_abft(
        torch, cfg, abft_mod, GuardedBackend, get_backend)
    emit("abft_checks", {"checks": abft_rows, "verdict_kernel": verdict_rows,
                         "verdicts": abft_verdict_rows, "timed": abft_timed})

    launches, params, ref_run, served = serve(
        torch, cfg, serve_mod, model_api, param_count, use_backend,
        get_backend, systolic_mac)
    emit("serve", served)
    if launches <= 0:
        fail("the served path launched the systolic_mac kernel no time")

    counters = Counters(systolic_mac=systolic_mac, wkv6=wkv6,
                        ssd_chunk=ssd_chunk)
    mods = types.SimpleNamespace(
        serve=serve_mod, use_backend=use_backend, get_backend=get_backend,
        model_api=model_api, ShapeConfig=ShapeConfig, param_count=param_count,
        ServeEngine=ServeEngine, get_config=get_config)
    ref = types.SimpleNamespace(requests=ref_run.requests,
                                engine=ref_run.engine,
                                model_step_ms=served["model_step_ms"],
                                peak_gb=served["peak_device_memory_gb"],
                                profile=served["profile"])
    emit("serve_hwloop", serve_hwloop(torch, cfg, mods, params, ref,
                                      counters, tiled))
    guard_launches, guarded = serve_guard(torch, cfg, mods, params, ref,
                                          counters, abft_mod)
    emit("serve_guard", guarded)
    if min(guard_launches["abft_checksums"],
           guard_launches["abft_verdict"]) <= 0:
        fail("the guarded path launched abft_checksums or abft_verdict no "
             "time")
    emit("autoscale", autoscale(torch, cfg, mods, params, tflow))
    http = serve_http(torch, cfg, mods, params, ref, systolic_mac)
    emit("serve_http", http)
    traced = serve_trace(torch, cfg, mods, systolic_mac)
    emit("serve_trace", traced)
    campaign = chaos(torch, cfg, params, abft_mod)
    emit("chaos", campaign)
    census = census_phase(torch, cfg, mods, params)
    emit("census", census)
    print(f"census: {census['seconds']:.1f} s", flush=True)
    example_launches, examples = examples_phase(torch, cfg, params,
                                                systolic_mac, tflow)
    emit("examples", examples)
    print(f"examples: {examples['seconds']:.1f} s ({smi})", flush=True)
    del params, ref_run, ref
    release(torch)

    # ---- the state-space models: served, decode against parallel, scored
    ssm_launches = {}
    for arch in SSM_ARCHS:
        cfg_a = get_config(arch)
        t0 = time.monotonic()
        api = model_api(cfg_a)
        params = api.init_params(SEED)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        row = serve_ssm(torch, arch, cfg_a, params, mods, counters)
        row["init_params_s"] = init_s
        emit("serve_ssm", row)
        ssm_launches[arch, "serve"] = row["launches"]
        emit("decode_vs_parallel", {"arch": arch, "backend": "ideal", "rows":
                                    decode_vs_parallel(
                                        torch, cfg_a, params, api, ssm_mod,
                                        layers_mod, ShapeConfig, counters,
                                        wkv6_plain, ssd_chunk_plain)})
        row = loss_phase(torch, cfg_a, params, api, ssm_mod,
                         (wkv6_plain, ssd_chunk_plain), counters)
        emit("loss", row)
        ssm_launches[arch, "loss"] = row["launches"]
        if cfg_a.family == "ssm":
            # the bf16 recurrence (ssm_bf16=True) on the same weights
            t0 = time.monotonic()
            wkv6_bf16_rows = check_wkv6_bf16(torch, wkv6, wkv6_plain)
            wkv6_bf16_run = wkv6_bf16_model(
                torch, cfg_a, params, mods, ssm_mod,
                (wkv6_plain, ssd_chunk_plain), counters, wkv6)
            bf16_s = time.monotonic() - t0
            emit("wkv6_bf16", {"checks": wkv6_bf16_rows,
                               "model": wkv6_bf16_run, "seconds": bf16_s})
            print(f"wkv6_bf16: {bf16_s:.1f} s", flush=True)
        del api, params
        release(torch)

    # ---- the other families: served through the launcher, then their
    # frontends (llava's patch prefill; seamless's and llama4's loss)
    family_launches = {}
    for arch in FAMILY_ARCHS:
        t0 = time.monotonic()
        cfg_a = family_config(get_config, arch)
        api = model_api(cfg_a)
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        params = api.init_params(SEED)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        row = serve_family(torch, arch, cfg_a, params, mods, counters,
                           layers_mod)
        row.update(init_params_s=init_s, init_peak_device_memory_gb=init_peak,
                   device_memory_held_before_init_gb=held_gb,
                   seconds=time.monotonic() - t0)
        emit("serve_families", row)
        family_launches[arch] = row["launches"]["systolic_mac"]
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        if cfg_a.family == "vlm":
            row = vlm_prefill(torch, cfg_a, params, api, mods, counters,
                              (systolic_mac_plain, largest_common_block))
            llava_prefill = row
        else:
            row = frontend_loss(torch, cfg_a, params, api, mods, counters)
        row.update(seconds=time.monotonic() - t0, peak_device_memory_gb=(
            torch.cuda.max_memory_allocated() / 1e9))
        emit("frontends", row)
        del api, params
        release(torch)

    # ---- training: phi4-mini at published width through the trainer
    t0 = time.monotonic()
    trained = train_phase(torch, cfg, mods, counters)
    trained["seconds"] = time.monotonic() - t0
    emit("train", trained)
    release(torch)

    # ---- training the state-space models at published width and depth:
    # the recurrences' backward kernels on the main path
    t0 = time.monotonic()
    ssm_trained = train_ssm(torch, mods, counters)
    ssm_trained["seconds"] = time.monotonic() - t0
    emit("train_ssm", ssm_trained)
    print(f"train_ssm: {ssm_trained['seconds']:.1f} s", flush=True)

    # ---- the device mesh: one rank, every family's train, prefill and
    # decode steps on it bit-equal to no mesh; the dry run on a fake group
    # of 256
    t0 = time.monotonic()
    meshed, mesh_launches = mesh_phase(torch, cfg, mods, counters)
    meshed["seconds"] = time.monotonic() - t0
    emit("mesh", meshed)
    step_s = {k: meshed["train"][k]["step_s"][1]
              for k in ("mesh", "rules_none")}
    print(f"mesh: second train step {step_s['mesh']:.3f} s on the one-rank "
          f"mesh beside {step_s['rules_none']:.3f} s with rules=None "
          f"({smi}); the phase {meshed['seconds']:.1f} s", flush=True)
    release(torch)

    emit("profile_misses", {"rows": PROFILE_MISSES,
                            "tries_per_measurement": PROFILE_TRIES})
    emit("total", {"seconds": time.monotonic() - t_start})

    # B1 over a phi4 train step's GEMMs, one shape at a time, held to its
    # limit as the profiled step was
    phi4_train = train_entry(shapes, trained)
    hold_b1_limit("phi4_train_step", phi4_train["device_ms"])

    # one decode step's GEMMs (225 launches at M = slots), from the
    # per-shape measurements above
    step = [s for s in shapes if s.get("M") == DECODE_M
            and s.get("arch") == ARCH and "launches_per_model_step" in s]
    total = lambda key: sum(s[key] * s["launches_per_model_step"]
                            for s in step)
    bounds = {s["bound_by"] for s in step}
    if len(bounds) != 1:
        fail(f"decode-step GEMMs are bound by {sorted(bounds)}: report them "
             f"apart")
    bound_by = bounds.pop()

    def device_total(rows, key):
        """Sum over a decode step's GEMMs, null if any is not measured."""
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(v * r["launches_per_model_step"]
                   for v, r in zip(vals, rows))

    kernels = [{
        "name": "systolic_mac", "route": "cuda",
        "source": "src/repro_torch/csrc/systolic_mac.cu",
        "replaces": "src/repro/kernels/systolic_mac.py:33",
        "launches": launches,
        "max_abs_err": max(s.get("max_err", s.get("max_err_clean", 0.0))
                           for s in shapes + ragged_rows),
        "timed": f"the {sum(s['launches_per_model_step'] for s in step)} "
                 f"GEMMs of one decode step at M={DECODE_M}, bf16, each "
                 f"weight cold in L2, as the reference backend launches "
                 f"them (counter=, a running count)",
        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"), "bound_by": bound_by,
        "library_ms": total("library_ms"),
        "device_ms": device_total(step, "device_ms"),
        "library_device_ms": device_total(step, "library_device_ms"),
        "device_ms_of": "the same GEMMs, device time by torch.profiler "
                        "(ms above: back to back by CUDA events, the "
                        "host's launch work included)",
        "launches_by_path": {"serve": launches,
                             "serve_http": http["kernel_launches"],
                             "serve_trace": traced["kernel_launches"],
                             "serve_families": family_launches,
                             "train": {
                                 "reference": trained["reference"][
                                     "systolic_mac_launches"],
                                 "int8_moments": trained["int8_moments"][
                                     "systolic_mac_launches"]},
                             "mesh": mesh_launches["systolic_mac"],
                             "examples": example_launches},
        "train_step": phi4_train,
        "train_step_by_arch": {
            arch: dict(train_entry(shapes, ssm_trained[arch], arch),
                       gemms=ssm_train_gemms(get_config(arch)),
                       gemms_timed="the bf16 GEMMs (rwkv6's f32 w_lora_b "
                                   "not timed)")
            for arch in SSM_ARCHS},
        "prefill": {
            "arch": llava_prefill["arch"],
            "M": llava_prefill["prefill_systolic_mac_M"],
            "launches": llava_prefill["prefill_gemms"]["calls"],
            "device_ms": llava_prefill["prefill_systolic_mac_device_ms"],
            "limit_ms": B1_LIMIT_MS["llava_prefill"],
            **{key: llava_prefill["prefill_gemms"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "prefill_s": llava_prefill["prefill_s"]["reference"]},
        "wide_form": {"from_M": WIDE_FROM_M, "dtype": "bfloat16",
                      "bit_equal_calls": len(wide_rows),
                      "limits_ms": B1_LIMIT_MS},
        "host_us_per_launch": {key: host[key] for key in (
            "systolic_mac_us", "reference_route_us", "torch_matmul_us")},
        "decode_step_by_arch": {
            arch: {key: device_total(
                [s for s in shapes if s.get("arch") == arch
                 and s.get("M") == DECODE_M
                 and "launches_per_model_step" in s], key)
                   for key in ("kernel_ms", "device_ms", "plain_ms",
                               "library_ms", "library_device_ms",
                               "bound_ms")}
            for arch in SSM_ARCHS + FAMILY_ARCHS}}]
    for name, source, replaces, rows, n, err_key in (
            ("razor_matmul", "src/repro_torch/csrc/razor_matmul.cu",
             "src/repro/kernels/razor_matmul.py:39", razor_rows, n_razor,
             "max_err_shadow"),
            ("precision_island", "src/repro_torch/csrc/precision_island.cu",
             "src/repro/kernels/precision_island.py:29", island_rows,
             n_island, "max_err_f32")):
        kernels.append(path_entry(name, source, replaces, rows, n, err_key))
    rwkv6_layers = get_config("rwkv6-1.6b").n_layers
    decode_row = next(r for r in wkv6_rows if r["case"] == "rwkv6 decode"
                      and r["b"] == DECODE_M)
    loss_row = next(r for r in wkv6_rows if r["case"] == "rwkv6 loss")
    entry = recurrence_entry(
        "wkv6", "src/repro_torch/csrc/wkv6.cu",
        "src/repro/kernels/wkv6.py:28", wkv6_rows, decode_row,
        ssm_launches["rwkv6-1.6b", "serve"]["wkv6"], rwkv6_layers,
        f"the {rwkv6_layers} launches of one rwkv6-1.6b decode step at "
        f"b={DECODE_M} (s=1, h 32, p 64), each state cold in L2; launches: "
        f"the serve_ssm run")
    if decode_row.get("kernel_device_ms") is not None:
        entry["device_ms"] = rwkv6_layers * decode_row["kernel_device_ms"]
        entry["device_ms_of"] = ("the same 24 launches, device time by "
                                 "torch.profiler: ms above is the host's "
                                 "launch rate")
    entry["host_us_per_call"] = decode_row["host_us_per_call"]
    entry["loss_shape"] = {k: loss_row[k] for k in (
        "b", "s", "h", "p", "chunk", "kernel_ms", "kernel_device_ms",
        "kernel_device_ms_by_pass", "plain_ms", "bound_ms", "bound_by")}
    entry["loss_shape"]["launches_per_loss_call"] = ssm_launches[
        "rwkv6-1.6b", "loss"]["wkv6"]
    entry["launches_by_path"] = {"serve_ssm": entry["launches"],
                                 "mesh": mesh_launches["wkv6"]}
    kernels.append(entry)
    bf_decode = next(r for r in wkv6_bf16_rows
                     if r["case"] == "rwkv6 decode" and r["b"] == DECODE_M)
    bf_loss = next(r for r in wkv6_bf16_rows if r["case"] == "rwkv6 loss")
    entry = recurrence_entry(
        "wkv6_bf16", "src/repro_torch/csrc/wkv6.cu (wkv6_bf16_launch)",
        "src/repro/kernels/wkv6.py:28 (its bf16 operands: the JAX package "
        "runs ssm_bf16 in jnp, src/repro/models/ssm.py:257)",
        wkv6_bf16_rows, bf_decode,
        wkv6_bf16_run["serve"]["launches"]["wkv6_bf16"], rwkv6_layers,
        f"the {rwkv6_layers} launches of one rwkv6-1.6b decode step at "
        f"b={DECODE_M} (s=1, h 32, p 64), r/k/v bf16, warm; launches: the "
        f"wkv6_bf16 phase's served run (ssm_bf16=True, reference)")
    entry["f32_kernel_ms"] = rwkv6_layers * bf_decode["f32_kernel_ms"]
    if bf_decode.get("kernel_device_ms") is not None:
        entry["device_ms"] = rwkv6_layers * bf_decode["kernel_device_ms"]
    entry["host_us_per_call"] = bf_decode["host_us_per_call"]
    entry["loss_shape"] = {k: bf_loss[k] for k in (
        "b", "s", "h", "p", "chunk", "kernel_ms", "f32_kernel_ms",
        "kernel_device_ms", "kernel_device_ms_by_pass",
        "f32_kernel_device_ms", "f32_kernel_device_ms_by_pass", "limit_ms",
        "plain_ms", "bound_ms", "f32_bound_ms", "bound_by")}
    entry["loss_shape"]["launches_per_loss_call"] = wkv6_bf16_run[
        "loss_launches"]["wkv6_bf16"]
    entry["launches_by_path"] = {"wkv6_bf16 (served)": entry["launches"],
                                 "mesh": mesh_launches["wkv6_bf16"]}
    kernels.append(entry)
    ssd_loss_row = next(r for r in ssd_rows if r["case"] == "zamba2 loss")
    entry = recurrence_entry(
        "ssd_chunk", "src/repro_torch/csrc/ssd_chunk.cu",
        "src/repro/kernels/ssd_chunk.py:26", ssd_rows, ssd_loss_row,
        ssm_launches["zamba2-2.7b", "loss"]["ssd_chunk"], 1,
        "one call at zamba2-2.7b's loss shape (b 2, s 2048, h 80, p 64, "
        "n 64, chunk 64); launches: one ModelAPI.loss call")
    entry["device_ms"] = ssd_loss_row["kernel_device_ms"]
    entry["device_ms_by_pass"] = ssd_loss_row["kernel_device_ms_by_pass"]
    entry["device_ms_of"] = ("the same call, its three passes' device time "
                             "by torch.profiler (ms above: back to back by "
                             "CUDA events)")
    entry["launches_by_path"] = {"loss": entry["launches"],
                                 "mesh": mesh_launches["ssd_chunk"]}
    kernels.append(entry)
    for name, source, fwd, rows, arch, shape_case, counted in (
            ("wkv6_bwd", "src/repro_torch/csrc/wkv6_bwd.cu",
             "src/repro/kernels/wkv6.py:28", wkv6_bwd_rows, "rwkv6-1.6b",
             "rwkv6", "recurrence_backward_launches"),
            ("wkv6_bwd_bf16",
             "src/repro_torch/csrc/wkv6_bwd.cu (wkv6_bwd_bf16_launch)",
             "src/repro/kernels/wkv6.py:28 with bf16 operands (the JAX "
             "package's ssm_bf16, src/repro/models/ssm.py:257)",
             wkv6_bwd_bf16_rows, "rwkv6-1.6b ssm_bf16", "rwkv6",
             "recurrence_bf16_backward_launches"),
            ("ssd_chunk_bwd", "src/repro_torch/csrc/ssd_chunk_bwd.cu",
             "src/repro/kernels/ssd_chunk.py:26", ssd_bwd_rows,
             "zamba2-2.7b", "zamba2", "recurrence_backward_launches")):
        kernel = name.split("_bwd")[0]
        run = ssm_trained[arch]["reference"]
        layers = ssm_trained[arch]["layers"]
        train_row = next(r for r in rows if r["case"] == f"{shape_case} "
                         f"train" and not r["state_grad"])
        loss_row = next(r for r in rows if r["case"] == f"{shape_case} loss"
                        and not r["state_grad"])
        worst = max(rows, key=lambda r: r["max_err"] / r["max_err_limit"])
        prof = run.get("recurrence_device_ms_per_step") or {}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"none: a kernel of the port, not a TPU kernel (the "
                        f"gradient of {fwd}'s function; the JAX package "
                        f"takes it by jax.grad of its jnp chunked form)",
            "launches": run[counted][kernel],
            "launches_by_path": {"train_ssm": run[counted][kernel],
                                 "mesh": mesh_launches[name]},
            "launches_of": f"train_ssm: {TRAIN_STEPS} {arch} train steps "
                           f"on reference",
            "max_abs_err": worst["max_err"],
            "max_err_limit": worst["max_err_limit"],
            "max_err_of": f"{worst['worst_grad']}, "
                          f"{worst['case']} (b, s) = "
                          f"{(worst['b'], worst['s'])}, state gradient "
                          f"{'random' if worst['state_grad'] else 'zero'}",
            "timed": f"the {layers} launches of one {arch} train step at "
                     f"(b, s) = {tuple(TRAIN_BATCH)}, each timed alone as "
                     f"a backward pass of a kept graph",
            "ms": layers * train_row["kernel_ms"],
            "plain_ms": layers * train_row["plain_ms"],
            "bound_ms": layers * train_row["bound_ms"],
            "bound_by": train_row["bound_by"],
            "library_ms": None,
            "library": f"none: no single PyTorch call computes {name}",
            "device_ms": (None if train_row["kernel_device_ms"] is None
                          else layers * train_row["kernel_device_ms"]),
            "device_ms_in_the_step": (
                sum(v for k, v in prof.items() if "_bwd_" in k
                    and k.startswith(kernel[:4])) or None),
            "device_ms_per_call": train_row["kernel_device_ms"],
            "device_ms_by_pass": train_row["kernel_device_ms_by_pass"],
            "launches_per_call": train_row["launches_per_call"],
            "device_ms_limit": train_row["device_ms_limit"],
            "device_ms_limit_held_against": "device_ms_per_call",
            "loss_shape": {k: loss_row[k] for k in (
                "b", "s", "h", "p", "chunk", "kernel_ms", "kernel_device_ms",
                "kernel_device_ms_by_pass", "launches_per_call",
                "device_ms_limit", "plain_ms", "bound_ms", "bound_by")}})
    def step_sum(key, rows):
        """A decode step's sum over its calls at each weight (None where a
        weight was not measured)."""
        vals = [r[key] for r in rows]
        return None if None in vals else sum(
            v * r["launches_per_model_step"] for v, r in zip(vals, rows))

    n_calls = sum(r["launches_per_model_step"] for r in abft_timed)
    by_of = lambda rows: max(  # noqa: E731
        set(r["bound_by"] for r in rows),
        key=lambda by: sum(r["bound_ms"] for r in rows if r["bound_by"] == by))
    v_timed = [dict(r["verdict"], launches_per_model_step=r[
        "launches_per_model_step"]) for r in abft_timed]

    def served_figure(name):
        """The kernel's device ms in a served guarded decode step, the
        figure serve_guard held to the limit."""
        key = f"{name}_device_ms_per_decode_step"
        return {"served_device_ms": guarded["reference"][key],
                "served_device_ms_of": "device ms a served guarded decode "
                                       "step (serve_guard (a)'s profiles)",
                "device_ms_limit": ABFT_STEP_LIMIT_MS[name],
                "device_ms_limit_held_against": "served_device_ms"}
    kernels.append({
        "name": "abft_checksums", "route": "cuda",
        "source": "src/repro_torch/csrc/abft_checksums.cu",
        "replaces": "src/repro/resilience/guard.py:146 (numpy; a kernel of "
                    "the port, not a TPU kernel)",
        "launches": guard_launches["abft_checksums"],
        "launches_of": "serve_guard (a): --backend reference --guard abft",
        "launches_by_path": {
            "serve_guard (a)": guard_launches["abft_checksums"],
            "chaos": campaign["abft_checksums_launches"]},
        "max_abs_err": max(r["max_err"] for r in abft_rows),
        "max_err_of": "as a fraction of the sums of magnitudes",
        "max_err_limit": TOL_ABFT,
        "timed": f"the {n_calls} calls of one guarded decode step (abft "
                 f"mode, M={DECODE_M}, bf16, each weight cold in L2)",
        "ms": step_sum("kernel_ms", abft_timed),
        "plain_ms": step_sum("plain_ms", abft_timed),
        "bound_ms": step_sum("bound_ms", abft_timed),
        "bound_by": by_of(abft_timed),
        "library_ms": step_sum("library_ms", abft_timed),
        "library": abft_timed[0]["library"],
        "device_ms": step_sum("device_ms", abft_timed),
        **served_figure("abft_checksums"),
        "host_us_per_call": next(r["host_us_per_call"] for r in abft_timed
                                 if "host_us_per_call" in r)})
    kernels.append({
        "name": "abft_verdict", "route": "cuda",
        "source": "src/repro_torch/csrc/abft_checksums.cu",
        "replaces": "src/repro/resilience/guard.py:148-159 (numpy; a kernel "
                    "of the port, not a TPU kernel)",
        "launches": guard_launches["abft_verdict"],
        "launches_of": "serve_guard (a): --backend reference --guard abft",
        "launches_by_path": {
            "serve_guard (a)": guard_launches["abft_verdict"],
            "chaos": campaign["abft_verdict_launches"]},
        "max_abs_err": max(r["max_err"] for r in verdict_rows),
        "max_err_of": "residuals as a fraction of their rows' and columns' "
                      "sums of magnitudes; counts and first indices equal",
        "max_err_limit": TOL_ABFT,
        "timed": f"the {n_calls} verifications of one guarded decode step "
                 f"(M={DECODE_M}, B1's float32 products; each weight's "
                 f"four products and one pack reused, hot in L2)",
        "ms": step_sum("kernel_ms", v_timed),
        "plain_ms": step_sum("plain_ms", v_timed),
        "bound_ms": step_sum("bound_ms", v_timed),
        "bound_by": by_of(v_timed),
        "library_ms": None,
        "library": "none: no single PyTorch call computes the verdict",
        "device_ms": step_sum("device_ms", v_timed),
        **served_figure("abft_verdict"),
        "host_us_per_call": next(r["verdict"]["host_us_per_call"]
                                 for r in abft_timed
                                 if "host_us_per_call" in r["verdict"])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
