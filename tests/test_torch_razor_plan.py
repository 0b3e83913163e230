"""The launch plan of the port's ``razor_matmul`` kernels, and the product's
arithmetic, on the CPU.

One ``razor_matmul`` call on the card is, on one stream: ``quant_rows`` of a
and of b^T, a product pass over 64 x 64 block tiles that walks K in k-tiles
of 64 (for bf16 operands warpgroup MMAs, int8 into int32 for the main path
and bf16 into f32 for the shadow; for f32 operands ``mma.sync``, int8 and a
3xTF32 split; each k-tile's shadow products summed into a fresh fragment
that is then added to the register sum), and two cell passes over (cell,
slice) grids, all sized by
:func:`repro_torch.kernels.razor_matmul.launch_plan`.  Here, without a card:
the plan's constants are read back from the CUDA source, its grids cover
every output element and k once, the workspace holds every piece the
launcher carves, and a test-side emulation of the product in the plan's
tiling and k order is held against the plain version (main cells bit for
bit, shadow cells within ``TOL_CLEAN`` of max|C|, rel within ``TOL_REL``,
flags equal outside a band of ``TOL_BAND * tol``), against
``repro.kernels.ref``'s oracle and, at K <= 1024 where its f32 sums of
integers are exact, the Pallas kernel run with ``interpret=True``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.razor_matmul import razor_matmul as j_razor_matmul
from repro_torch.kernels import _build
from repro_torch.kernels import quant_rows as qmod
from repro_torch.kernels import razor_matmul as rmod
from repro_torch.kernels import ref as tref
from repro_torch.kernels.razor_matmul import launch_plan, razor_matmul_plain
from repro_torch.kernels.tuning import select_blocks

SRC = (_build.CSRC_DIR / "razor_matmul.cu").read_text()
#: the tensor-core products, the TMA ring and its constants, shared with
#: precision_island.cu
RING = (_build.CSRC_DIR / "tc_ring.cuh").read_text()
#: the sources with every run of white space made one space
FLAT = " ".join(SRC.split())
RING_FLAT = " ".join(RING.split())

#: the tolerances chip_smoke.py holds the kernel to (its TOL_CLEAN,
#: TOL_REL, TOL_BAND)
TOL_CLEAN, TOL_REL, TOL_BAND = 1e-5, 1e-4, 1e-4

#: (M, K, N): phi4-mini-3.8b's four weights at a 256-row chunk, the JAX
#: tests' shapes, chip_smoke.py's ragged case, the outlier case
PLAN_SHAPES = [(256, 3072, 3072), (256, 3072, 1024), (256, 3072, 8192),
               (256, 8192, 3072), (256, 256, 256), (128, 384, 256),
               (96, 100, 80), (128, 256, 256), (1, 1, 1), (24, 40, 200)]


def _constexpr(name, text=RING):
    hit = re.search(rf"constexpr int {name} = (\w+);", text)
    assert hit, name
    return hit.group(1)


def test_plan_constants_are_the_cuda_sources():
    assert int(_constexpr("BM")) == rmod.TILE_M == 64
    assert int(_constexpr("BN")) == rmod.TILE_N == 64
    assert int(_constexpr("BK")) == rmod.TILE_K == 64
    assert int(_constexpr("STAGES")) == rmod.STAGES
    assert int(_constexpr("THREADS")) + 32 == rmod.BLOCK_THREADS
    assert "constexpr int BLOCK = THREADS + 32;" in RING
    assert int(_constexpr("K_PAD")) == qmod.K_TILE
    assert int(_constexpr("MAX_SLICES", SRC)) == rmod.MAX_SLICES
    assert int(_constexpr("WS_ALIGN")) == rmod.WS_ALIGN
    # the product's constants come from the shared header alone
    assert '#include "tc_ring.cuh"' in SRC
    for name in ("BM", "BN", "BK", "STAGES", "THREADS", "K_PAD", "WS_ALIGN",
                 "QROW"):
        assert f"constexpr int {name} =" not in SRC, name
    # the grids and the k loop, as LaunchPlan computes them
    assert "Problem p{M, N, K, (K + BK - 1) / BK," in RING_FLAT
    for text in ("const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);",
                 "const int Kp = (K + K_PAD - 1) / K_PAD * K_PAD;",
                 "const dim3 grid(grid_m * cells.grid_n, cells.slices);",
                 "*lo = units * slice / c.slices;",
                 "*hi = units * (slice + 1) / c.slices;",
                 "if (block_n % 4 == 0 && N % 4 == 0 && aligned16(cc)) "
                 "return launch_cells<4>"):
        assert text in FLAT, text
    # the workspace is carved in LaunchPlan.workspace_pieces' order
    carved = re.findall(r"w->(\w+) = reinterpret_cast<[\w ]+\*>\(take\(",
                        SRC)
    names = {"qa": "qa", "qb": "qb", "sa": "scale_a", "sb": "scale_b",
             "amax_a": "amax_a", "amax_b": "amax_b", "main": "main",
             "shadow": "shadow", "partial": "partial"}
    assert [names[c] for c in carved] == [
        p for p, _ in launch_plan(8, 8, 8, 8, 8).workspace_pieces()]
    # the k-tile of the int8 copies is the float tiles' k-tile: 64 bytes
    assert "constexpr int QROW = BK;" in RING
    # a stage holds a, b and both int8 copies' tiles
    assert ("BYTES = L::A_BYTES + L::B_BYTES + L::QA_BYTES + L::QB_BYTES;"
            in FLAT)


def test_tensor_core_forms_and_no_float_atomics():
    """bf16 operands on warpgroup MMAs (wgmma): the main path int8 into
    int32, the shadow bf16 into f32, each k-tile's four k16 steps into a
    fresh sum (scale-d 0 on the first) waited for and added to the register
    sum; f32 operands on mma.sync, int8 into int32 and a 3xTF32 split (three
    products a k-step); copies by TMA; the only atomic is the integer
    count.  The forms live in tc_ring.cuh, which razor_matmul.cu
    includes; each of its k-tiles issues both products."""
    assert "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8" in RING
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in RING
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in RING
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in RING
    assert RING_FLAT.count("mma_tf32(d, ") == 3
    assert "smem_desc(Bs + (KFAST ? 32 * kk : 2048 * kk), 1024, 1), kk > 0);" \
        in RING_FLAT
    for text in ("wgmma_fence(); issue_bf16_tile<KFAST>(As, Bs, t); "
                 "issue_s8_tile(Qa, Qb, iacc); wgmma_commit();",
                 "tf32_tile<KFAST>(As, Bs, t, wr, wc, lane); "
                 "s8_tile(Qa, Qb, iacc, wr, wc, lane);"):
        assert text in FLAT, text
    assert "wgmma_wait<0>(); fence_regs(t);" in FLAT
    assert "for (int e = 0; e < 32; ++e) acc[e] += t[e];" in FLAT
    assert "cp.async.bulk.tensor.2d" in RING
    assert re.findall(r"atomic\w+\([^,]+", SRC) == ["atomicAdd(count"]
    assert not re.findall(r"atomic\w+\(", RING)
    for text in (SRC, RING):
        assert "__dp4a" not in text and "fmaf(av" not in text
        assert '#include "tile_products.cuh"' not in text


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_grids_cover_the_output_and_k_once(m, k, n):
    bm, bn = select_blocks(m, n)
    plan = launch_plan(m, n, k, bm, bn)
    assert plan.row_tiles * rmod.TILE_M >= m > (plan.row_tiles - 1) * 64
    assert plan.col_tiles * rmod.TILE_N >= n > (plan.col_tiles - 1) * 64
    # the k-tiles cover K, and the zero-padded int8 rows, exactly once
    assert plan.k_tiles * rmod.TILE_K >= plan.kp >= k
    assert plan.kp > (plan.k_tiles - 1) * rmod.TILE_K
    assert plan.kp % qmod.K_TILE == 0
    # the slices partition each cell's runs, in order
    assert plan.cells == (m // bm) * (n // bn)
    assert 1 <= plan.slices <= rmod.MAX_SLICES
    ranges = plan.slice_ranges()
    assert ranges[0][0] == 0
    assert ranges[-1][1] * plan.run() == bm * bn
    assert all(hi == lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_workspace_holds_every_piece_aligned(m, k, n):
    bm, bn = select_blocks(m, n)
    plan = launch_plan(m, n, k, bm, bn)
    total, off = plan.workspace_bytes(), 0
    for name, nbytes in plan.workspace_pieces():
        assert off % rmod.WS_ALIGN == 0, name
        off += -(-nbytes // rmod.WS_ALIGN) * rmod.WS_ALIGN
    assert off == total
    pieces = dict(plan.workspace_pieces())
    assert pieces["qb"] == n * plan.kp and pieces["main"] == 4 * m * n
    assert pieces["partial"] == 8 * plan.cells * plan.slices


def test_phi4_shapes_fill_the_card():
    """At a 256-row chunk every phi4-mini weight gives the product pass at
    least a quarter block per SM (132 SMs), and w1/wg several waves."""
    for k, n in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)):
        plan = launch_plan(256, n, k, *select_blocks(256, n))
        assert plan.row_tiles * plan.col_tiles >= 32
        assert plan.cells * plan.slices >= 64
    assert launch_plan(256, 8192, 3072, 128, 128).col_tiles * 4 == 512


# ------------------------------------------------------------ emulation ----


def _tf32(x):
    """cvt.rna.tf32.f32's rounding of finite f32 values: to a 10-bit
    mantissa, to nearest, ties away from zero (the kernel's to_tf32)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulate(a, b, tol, bm, bn, f32):
    """The kernels' function in their tiling and order, numpy: (C, flags,
    rel, main, shadow).  a (M, K), b (K, N) float32 arrays holding the
    operands' values; ``f32``: the operands are f32 (the 3xTF32 shadow)."""
    m, k = a.shape
    n = b.shape[1]
    plan = launch_plan(m, n, k, bm, bn)
    tk = rmod.TILE_K
    # the int8 copies and scales: the plain quantizer (quant_rows equals it
    # bit for bit on the card), rows zero-padded to Kp
    qa, sa = tref.quantize_sym_i8(torch.from_numpy(a))
    qb, sb = tref.quantize_sym_i8(torch.from_numpy(np.ascontiguousarray(b.T)))
    qa = np.pad(qa.numpy(), ((0, 0), (0, plan.kp - k)))
    qb = np.pad(qb.numpy(), ((0, 0), (0, plan.kp - k)))
    sa, sb = sa.numpy()[:, 0], sb.numpy()[:, 0]
    # main: each k-tile's two k32 MMA steps summed in int32; exact
    iacc = np.zeros((m, n), np.int32)
    for t in range(plan.k_tiles):
        for s in range(t * tk, min((t + 1) * tk, plan.kp), 32):
            part = (qa[:, s:s + 32].astype(np.int64)
                    @ qb[:, s:s + 32].astype(np.int64).T)
            iacc = (iacc.astype(np.int64) + part).astype(np.int32)
    main = (iacc.astype(np.float32) * sa[:, None]) * sb[None, :]
    # shadow: a fresh f32 sum per k-tile (products exact: bf16 x bf16, or
    # the three TF32 x TF32 products of the split), added to the f32 sum
    # in ascending tiles
    shadow = np.zeros((m, n), np.float32)
    for t in range(plan.k_tiles):
        ks = slice(t * tk, min((t + 1) * tk, k))
        at, bt = a[:, ks], b[ks, :]
        if f32:
            ah, bh = _tf32(at), _tf32(bt)
            al, bl = _tf32(at - ah), _tf32(bt - bh)
            tile = (al.astype(np.float64) @ bh + ah.astype(np.float64) @ bl
                    + ah.astype(np.float64) @ bh)
        else:
            tile = at.astype(np.float64) @ bt.astype(np.float64)
        shadow = (shadow + tile.astype(np.float32)).astype(np.float32)
    # the cell passes: per slice a sum of the cell's runs, the slices added
    # in order, then rel and the decision
    gm, gn = m // bm, n // bn
    flags = np.zeros((gm, gn), np.int32)
    rel = np.zeros((gm, gn), np.float32)
    c = main.copy()
    v = plan.run()
    for i in range(gm):
        for j in range(gn):
            cm = main[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn].reshape(-1)
            cs = shadow[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn].reshape(-1)
            d2 = s2 = np.float32(0)
            for lo, hi in plan.slice_ranges():
                d = (cm[lo * v:hi * v] - cs[lo * v:hi * v]).astype(np.float64)
                d2 = np.float32(d2 + np.float32((d * d).sum()))
                s2 = np.float32(s2 + np.float32(
                    (cs[lo * v:hi * v].astype(np.float64) ** 2).sum()))
            r = np.float32(np.sqrt(d2) / (np.sqrt(s2) + np.float32(1e-12)))
            rel[i, j], flags[i, j] = r, int(r > tol)
            if r > tol:
                c[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] = \
                    shadow[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]
    return c, flags, rel, main, shadow


def _split_tol(rel):
    """A tol halfway across the widest gap between sorted cell errors."""
    r = np.sort(np.asarray(rel, np.float64).ravel())
    if r.size == 1:
        return float(r[0]) * 0.5
    i = int(np.argmax(np.diff(r)))
    return float((r[i] + r[i + 1]) / 2)


#: (M, K, N): the JAX tests' shapes, the ragged case (cells 32 x 16, K not
#: a multiple of the k-tile), K = 1024 (the Pallas kernel's f32 sums of
#: integers still exact), and K = 3072 (48 k-tiles, phi4's d_model)
EMU_SHAPES = [(256, 256, 256), (128, 384, 256), (96, 100, 80),
              (128, 1024, 128), (64, 3072, 256)]


@pytest.mark.parametrize("m,k,n", EMU_SHAPES)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_emulated_tiling_equals_the_plain_version(m, k, n, dtype):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b[0, :n // 2] *= 40.0                      # outliers: both kinds of cell
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    a, b = ta.float().numpy(), tb.float().numpy()     # the operands' values
    bm, bn = select_blocks(m, n)
    _, _, rel0 = razor_matmul_plain(ta, tb, tol=1.0, block_m=bm, block_n=bn)
    tol = _split_tol(rel0.numpy())
    c_ref, f_ref, rel_ref = (x.numpy() for x in razor_matmul_plain(
        ta, tb, tol=tol, block_m=bm, block_n=bn))
    c, flags, rel, main, shadow = _emulate(a, b, tol, bm, bn, dtype == "f32")
    # flags outside the band around tol, rel, and both kinds of cell
    band = np.abs(rel_ref.astype(np.float64) - tol) <= TOL_BAND * tol
    np.testing.assert_array_equal(flags[~band], f_ref[~band])
    np.testing.assert_allclose(rel, rel_ref, rtol=TOL_REL)
    assert 0 < int(f_ref.sum()) < f_ref.size or f_ref.size == 1
    # main cells bit for bit (the exact int32 product, one dequant order);
    # shadow cells within TOL_CLEAN of max|C|
    cells = lambda x: np.repeat(np.repeat(x, bm, 0), bn, 1)
    keep_main = cells((flags == 0) & (f_ref == 0))
    keep_shadow = cells((flags == 1) & (f_ref == 1))
    np.testing.assert_array_equal(c[keep_main].view(np.int32),
                                  c_ref[keep_main].view(np.int32))
    lim = TOL_CLEAN * float(np.abs(c_ref).max())
    assert float(np.abs(c - c_ref)[keep_shadow].max(initial=0.0)) <= lim
    # the whole shadow plane, against the f32 product of the same values
    exact = (a.astype(np.float64) @ b.astype(np.float64))
    assert float(np.abs(shadow - exact).max()) <= TOL_CLEAN * float(
        np.abs(exact).max())
    # repro.kernels.ref's oracle: the same main plane, bit for bit
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    jqa, jsa = jref.quantize_sym_i8(ja)
    jqb, jsb = jref.quantize_sym_i8(jb.T)
    jmain = np.asarray((jnp.dot(jqa.astype(jnp.int32), jqb.astype(jnp.int32).T)
                        .astype(jnp.float32) * jsa) * jsb.T)
    np.testing.assert_array_equal(main.view(np.int32), jmain.view(np.int32))
    if k > 1024 or m % 128 or n % 128:
        return
    # the Pallas kernel at K <= 1024 (its block is 128 x 128): its flags,
    # and its main cells.  f32: to a few f32 roundings (its integer sums are
    # exact here and its scales equal the oracle's, but XLA evaluates its
    # dequantization in another order, up to 3 ulp apart).  bf16: at the
    # JAX tests' tolerances, as tests/test_torch_kernels.py holds the plain
    # version (its bf16 main path lies up to 0.008 from the oracle's here)
    pc, pf, _ = j_razor_matmul(ja, jb, tol=tol, interpret=True)
    pc, pf = np.asarray(pc), np.asarray(pf)
    np.testing.assert_array_equal(pf, flags)
    rtol, atol = (1e-6, 0.0) if dtype == "f32" else (3e-3, 0.15)
    np.testing.assert_allclose(c[keep_main], pc[keep_main], rtol=rtol,
                               atol=atol)


def test_integer_tiles_stay_exact_past_two_to_the_24():
    """Operands whose int8 copies are all +-127 over K = 8192: the partial
    sums of the k-tiles pass 2^24 (an f32 sum of them would round), and the
    int32 sum of the tiles is the exact product, as the plain version's."""
    k = 8192
    a = np.ones((2, k), np.float32)
    b = np.ones((k, 3), np.float32)
    b[::2, 1] = -1.0
    b[1, 2] = 0.5
    _, _, _, main, _ = _emulate(a, b, np.inf, 2, 3, True)
    c_ref, flags, _ = razor_matmul_plain(torch.from_numpy(a),
                                         torch.from_numpy(b), tol=np.inf,
                                         block_m=2, block_n=3)
    assert int(flags.sum()) == 0 and k * 127 * 127 > 2 ** 24
    np.testing.assert_array_equal(main.view(np.int32),
                                  c_ref.numpy().view(np.int32))
    # column 2 holds one 64 among 8191 127s: k * 127^2 - 127 * 63, odd
    acc = np.float64((k - 1) * 127 * 127 + 127 * 64)
    sa = np.float32(1.0) / np.float32(127.0)
    assert main[0, 2] == np.float32(np.float32(acc) * sa) * sa
    assert main[0, 1] == 0.0


# ------------------------------------------------------------ prologue ----


def _quant_by_reciprocal(x, levels):
    """quant_rows.cu's rule in numpy float32 (IEEE, round to nearest):
    y = x * RN(1 / scale), rint(y) unless y lies within 2^-14 of a
    half-integer, where the true division x / scale decides."""
    amax = np.abs(x).max(axis=1)
    sc = np.maximum(amax, np.float32(1e-12)) / np.float32(levels)
    inv = np.float32(1.0) / sc
    y = x * inv[:, None]
    q = np.rint(y)
    near = np.abs(np.abs(y - q) - np.float32(0.5)) <= np.float32(2.0 ** -14)
    q = np.where(near, np.rint(x / sc[:, None]), q)
    return np.clip(q, -levels, levels).astype(np.int8), sc, int(near.sum())


@pytest.mark.parametrize("levels", [127, 7])
def test_quantize_by_reciprocal_equals_the_division(levels):
    """The quantizer multiplies by the row's reciprocal scale and divides
    only near a half-integer; it must give the oracle's bits.  Random rows
    (f32 and bf16 values), and rows built so that x / scale falls within a
    few ulp of k + 1/2 for every k (where the two could part)."""
    rng = np.random.default_rng(17)
    rows = [rng.standard_normal((64, 512)).astype(np.float32),
            torch.from_numpy(rng.standard_normal((64, 512)).astype(
                np.float32)).to(torch.bfloat16).float().numpy()]
    s0 = rng.uniform(0.5, 2.0, (256, 1)).astype(np.float32) * np.float32(
        2.0) ** rng.integers(-20, 20, (256, 1)).astype(np.float32)
    k = rng.integers(-levels, levels, (256, 1024)) + 0.5
    jitter = rng.integers(-8, 9, (256, 1024)) * 2.0 ** -20
    near = ((k + k * jitter) * s0).astype(np.float32)
    near[:, 0] = np.float32(levels) * s0[:, 0]         # amax: scale ~ s0
    rows.append(near)
    taken = 0
    for x in rows:
        q, sc, n_div = _quant_by_reciprocal(x, levels)
        oracle = tref.quantize_sym_i8 if levels == 127 else \
            tref.quantize_sym_i4
        q_ref, s_ref = oracle(torch.from_numpy(x))
        np.testing.assert_array_equal(q, q_ref.numpy())
        np.testing.assert_array_equal(sc.view(np.int32),
                                      s_ref.numpy()[:, 0].view(np.int32))
        taken += n_div
    assert taken > 1000          # the adversarial rows do reach the division
