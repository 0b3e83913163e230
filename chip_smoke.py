#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc``, holds each against its
plain PyTorch version at the shapes the model gives it, runs the paper flow on
one full-width weight, runs the precision-island loop
(``repro_torch.examples.precision_islands``: Razor flags -> Algorithm-2 tier
calibration -> tiered product, on the ``razor_matmul`` and
``precision_island`` kernels) at phi4-mini-3.8b's four weight shapes, and
serves a few requests on phi4-mini-3.8b at its published width and depth
through ``repro_torch.launch.serve`` -> ``ServeEngine`` -> ``ModelAPI`` ->
``backend.matmul`` -> the ``systolic_mac`` kernel.  Weights are random, from
seeded generators.  Needs a GPU and ``nvcc``; any phase that fails ends the
run with a non-zero exit code.

Output: one JSON object per line — ``env``, ``build``, ``kernel_checks``
(``systolic_mac``, ``razor_matmul``, ``precision_island``), ``paper_flow``,
``precision_islands``, ``serve`` (with a ``torch.profiler`` pass over a short
run), ``total`` (the script's seconds), then ``{"kernels": [...]}`` (per
kernel: launches on its path, error against the plain version, time, the
plain version's and one library call's time, and the least time the card
could take), the card's name and power limit as ``nvidia-smi`` gives them,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12,      # tensor cores, f32 accumulate
              "float32": 67e12}        # outside the tensor cores
PEAK_INT8_OPS = 1979e12                # tensor cores

ARCH = "phi4-mini-3.8b"
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


def check_serving_shapes(torch, cfg, systolic_mac, systolic_mac_plain,
                         largest_common_block):
    """Every (K, N) the model multiplies by, bf16, nominal rails, on the flag
    grid the reference backend uses: checked at every M the served run can
    give (1 to 7: a prompt's length in prefill, the slots in decode), timed
    at M in {1, 4, 7}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    d, qd, kvd, ff, vocab = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                             cfg.padded_vocab)
    # name -> (K, N, launches per model step, transposed view?)
    weights = {
        "wq/wo": (d, qd, 2 * cfg.n_layers, False),
        "wk/wv": (d, kvd, 2 * cfg.n_layers, False),
        "w1/wg": (d, ff, 2 * cfg.n_layers, False),
        "w2": (ff, d, cfg.n_layers, False),
        "logits": (d, vocab, 1, True),
    }
    out = []
    for name, (k, n, per_step, transposed) in weights.items():
        # enough copies to exceed the 50 MB L2 between reuses
        copies = max(1, math.ceil(120e6 / (2 * k * n)))
        if transposed:      # the tied unembedding: (V, d) storage, .T view
            store = torch.randn((copies, n, k), generator=gen, device=dev,
                                dtype=torch.float32).mul_(0.02).to(
                                    torch.bfloat16)
            bs = [store[i].T for i in range(copies)]
        else:
            store = torch.randn((copies, k, n), generator=gen, device=dev,
                                dtype=torch.float32).mul_(
                                    1 / math.sqrt(k)).to(torch.bfloat16)
            bs = [store[i] for i in range(copies)]
        for m in range(1, 8):
            a = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
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
                fail(f"systolic_mac {name} M={m}: max err {err} over "
                     f"limit {TOL_CLEAN * scale}")
            if not flags_equal or int(count) != 0 or int(flags.sum()) != 0:
                fail(f"systolic_mac {name} M={m}: flags differ or fired at "
                     f"nominal rails")

            entry = {
                "weight": name, "M": m, "K": k, "N": n, "dtype": "bfloat16",
                "b_transposed_view": transposed, "flag_cell": block,
                "max_err": err, "max_err_limit": TOL_CLEAN * scale,
                "flags_equal": flags_equal}
            out.append(entry)
            if m not in (1, DECODE_M, 7):
                continue
            iters = 4 if transposed else 24
            t_kernel = time_ms(
                lambda i: systolic_mac(a, bs[i], v_map, v_safe, block_m=block,
                                       block_n=block, count_flags=True),
                copies, iters)
            t_plain = time_ms(
                lambda i: systolic_mac_plain(a, bs[i], v_map, v_safe,
                                             block_m=block, block_n=block),
                copies, iters)
            t_lib = time_ms(lambda i: torch.matmul(a, bs[i]), copies, iters)
            t_bound, by = bound_ms(m, k, n, gm, gn, "bfloat16")
            entry.update({
                "launches_per_model_step": per_step, "kernel_ms": t_kernel,
                "plain_ms": t_plain, "library_ms": t_lib,
                "bound_ms": t_bound, "bound_by": by})
        del store, bs
    return out


def check_faulting(torch, systolic_mac, systolic_mac_plain):
    """Rails drawn around the safe voltage, in f32 and bf16, at 0, 8 and 23
    kept mantissa bits: flags, the fused count, both tolerances, and the
    epilogue bit for bit.  The kernel sums an element in one fixed order, so
    its result at these rails must equal its own result at nominal rails
    with exactly the flagged cells masked."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    m, k, n, bm, bn = 256, 384, 512, 64, 128
    gm, gn = m // bm, n // bn
    out = []
    for dtype in (torch.float32, torch.bfloat16):
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


def integer_gemm_bound_ms(m, k, n, elem, ops_s, levels_used, grid_cells,
                          extra_out):
    """Least time for a product with int8 prologue copies: a and b read
    once, C written once, each int8 copy of a and b written and read once
    per level in use, the cell outputs (``extra_out`` bytes); against
    ``ops_s`` seconds of arithmetic at the peak rates."""
    nbytes = (elem * (m * k + k * n) + 4 * m * n
              + levels_used * 2 * (m * k + n * k) + 4 * grid_cells
              + extra_out)
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
    torch.cuda.synchronize()
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
            del bs
            ops_s = (2.0 * m * n * k / PEAK_INT8_OPS
                     + 2.0 * m * n * k / PEAK_FLOPS[dname])
            gcells = (m // bm) * (n // bn)
            t_bound, by = integer_gemm_bound_ms(
                m, k, n, 2 if dtype == torch.bfloat16 else 4, ops_s, 1,
                2 * gcells, 4)
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
    m, n = a.shape[0], b.shape[1]
    gm, gn = tiers.shape
    bm, bn = m // gm, n // gn
    c = precision_island(a, b, tiers)
    torch.cuda.synchronize()
    c_ref = precision_island_plain(a, b, tiers, block_m=bm, block_n=bn)
    exact = cells_mask(torch, (tiers == 0) | (tiers == 1), bm, bn)
    err, lim = compare_cells(torch, c, c_ref, exact, what)
    return {"M": m, "K": a.shape[1], "N": n,
            "dtype": str(a.dtype).replace("torch.", ""),
            "flag_cell": [bm, bn],
            "cells_per_tier": [int((tiers == t).sum()) for t in range(3)],
            "integer_cells_bit_equal": True, "max_err_f32": err,
            "max_err_limit": lim}


def check_precision_island(torch, cfg, kernels):
    """precision_island at M = 256 against each full-width weight with every
    tier present, and at the JAX tests' shapes and maps, bf16 and f32;
    times."""
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
            del bs
            per_cell = 2.0 * ISLAND_BLOCK * ISLAND_BLOCK * k
            n_t = entry["cells_per_tier"]
            ops_s = ((n_t[0] + n_t[1]) * per_cell / PEAK_INT8_OPS
                     + n_t[2] * per_cell / PEAK_FLOPS[dname])
            levels = int(n_t[0] > 0) + int(n_t[1] > 0)
            t_bound, by = integer_gemm_bound_ms(
                m, k, n, 2 if dtype == torch.bfloat16 else 4, ops_s, levels,
                gm * gn, 0)
            entry.update({"kernel_ms": t_kernel, "plain_ms": t_plain,
                          "library_ms": t_lib,
                          "library": "torch.matmul (the f32 product alone)",
                          "bound_ms": t_bound, "bound_by": by})
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


def profile_calls(torch, calls):
    """Device time by CUDA kernel of one call of each wrapper (after the
    calls above warmed them up), by ``torch.profiler``: where a wrapper's
    time goes among its prologue, product and cell passes.  Null where the
    profiler sees no device time (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        # a session can come back without device rows (seen on the first of
        # a process): up to three tries
        for _ in range(3):
            with profile(activities=activities) as prof:
                fn()
                torch.cuda.synchronize()
            rows = [{"kernel": kernel_name(e.key),
                     "ms": e.self_device_time_total / 1e3, "calls": e.count}
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            if sum(r["ms"] for r in rows) > 0:
                break
        rows.sort(key=lambda r: -r["ms"])
        out[name] = rows if sum(r["ms"] for r in rows) > 0 else None
    return out


def profile_serve(torch, serve_mod, params):
    """A short `reference` run under ``torch.profiler``: the device time of
    a model step by kernel, and the share of the run's wall time in which
    the device ran a kernel.  Tracing slows the host, so the share is a
    lower bound of an untraced run's.  Where the profiler sees no device
    time, the numbers are null (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = serve_mod.parse_args(
        ["--arch", ARCH, "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
         "--requests", str(SLOTS), "--max-new", "3", "--backend",
         "reference"])
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
        return {"model_steps": steps, "device_ms_per_model_step": None,
                "device_busy_share_traced": None, "top_kernels": None}
    return {"model_steps": steps, "traced_wall_ms": 1e3 * run.wall_s,
            "device_ms_per_model_step": device_ms / steps,
            "device_busy_share_traced": device_ms / (1e3 * run.wall_s),
            "kernels_per_model_step": sum(n for _, _, n in rows) / steps,
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

    return launches, {
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


def path_entry(name, source, replaces, rows, launches, err_key):
    """A kernel's entry of the ``kernels`` line: one call at each of the
    model's weight shapes at M = 256, bf16, summed; the largest error of
    any check beside its limit."""
    timed = [r for r in rows if "kernel_ms" in r and r["dtype"] == "bfloat16"]
    bounds = {r["bound_by"] for r in timed}
    if len(bounds) != 1:
        fail(f"{name}: the timed shapes are bound by {sorted(bounds)}: report "
             f"them apart")
    checked = [r for r in rows if err_key in r]
    worst = max(checked, key=lambda r: r[err_key] / r["max_err_limit"])
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": worst[err_key], "max_err_limit": worst["max_err_limit"],
        "integer_cells": "bit-equal to the plain version",
        "timed": f"one call at each of the {len(timed)} weight shapes, "
                 f"M={CHUNK_M}, bf16, each weight cold in L2, summed",
        "ms": sum(r["kernel_ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": bounds.pop(),
        "library_ms": sum(r["library_ms"] for r in timed),
        "library": f"{timed[0]['library']}; no single PyTorch call computes "
                   f"{name}"}


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
    from repro_torch.examples import precision_islands as islands
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.precision_island import (precision_island,
                                                      precision_island_plain)
    from repro_torch.kernels.quant_rows import quant_rows
    from repro_torch.kernels.razor_matmul import (razor_matmul,
                                                  razor_matmul_plain)
    from repro_torch.kernels.systolic_mac import (systolic_mac,
                                                  systolic_mac_plain)
    from repro_torch.kernels.tuning import select_blocks
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model_api, param_count

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
    shapes = check_serving_shapes(torch, cfg, systolic_mac,
                                  systolic_mac_plain, largest_common_block)
    shapes += check_faulting(torch, systolic_mac, systolic_mac_plain)
    razor_rows = check_razor(
        torch, cfg, (razor_matmul, razor_matmul_plain, quant_rows), ref,
        select_blocks)
    island_rows = check_precision_island(
        torch, cfg, (precision_island, precision_island_plain))
    emit("kernel_checks", {"systolic_mac": shapes,
                           "razor_matmul": razor_rows,
                           "precision_island": island_rows})

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

    launches, served = serve(torch, cfg, serve_mod, model_api, param_count,
                             use_backend, get_backend, systolic_mac)
    emit("serve", served)
    if launches <= 0:
        fail("the served path launched the systolic_mac kernel no time")

    emit("total", {"seconds": time.monotonic() - t_start})

    # one decode step's GEMMs (225 launches at M = slots), from the
    # per-shape measurements above
    step = [s for s in shapes if s.get("M") == DECODE_M
            and "launches_per_model_step" in s]
    total = lambda key: sum(s[key] * s["launches_per_model_step"]
                            for s in step)
    bounds = {s["bound_by"] for s in step}
    if len(bounds) != 1:
        fail(f"decode-step GEMMs are bound by {sorted(bounds)}: report them "
             f"apart")
    bound_by = bounds.pop()
    kernels = [{
        "name": "systolic_mac", "route": "cuda",
        "source": "src/repro_torch/csrc/systolic_mac.cu",
        "replaces": "src/repro/kernels/systolic_mac.py:33",
        "launches": launches,
        "max_abs_err": max(s.get("max_err", s.get("max_err_clean", 0.0))
                           for s in shapes),
        "timed": f"the {sum(s['launches_per_model_step'] for s in step)} "
                 f"GEMMs of one decode step at M={DECODE_M}, bf16, each "
                 f"weight cold in L2",
        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"), "bound_by": bound_by,
        "library_ms": total("library_ms")}]
    for name, source, replaces, rows, n, err_key in (
            ("razor_matmul", "src/repro_torch/csrc/razor_matmul.cu",
             "src/repro/kernels/razor_matmul.py:39", razor_rows, n_razor,
             "max_err_shadow"),
            ("precision_island", "src/repro_torch/csrc/precision_island.cu",
             "src/repro/kernels/precision_island.py:29", island_rows,
             n_island, "max_err_f32")):
        kernels.append(path_entry(name, source, replaces, rows, n, err_key))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
