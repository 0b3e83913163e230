"""The launch plan of the port's ``precision_island`` kernels, and their
arithmetic, on the CPU.

One ``precision_island`` call on the card is, on one stream: a one-block
pass that reduces the tier map to a word of the tiers present, the
quantization of a and of b^T (the row maxima found once, then one pass that
writes the int8 copies of both levels, or only those the word holds), and a
product pass over 64 x 64 block tiles in which a block runs one walk over K
for every tier its tile covers (int4 and int8 on int8 tensor-core MMAs into
int32, f32 in bf16 MMAs or a 3xTF32 split, each k-tile of 64 into a fresh
f32 fragment added to the register sum), all sized by
:func:`repro_torch.kernels.precision_island.launch_plan`.  Here, without a
card: the plan's constants are read back from the CUDA sources, its grids
cover every output element and each walk every k once, the workspace holds
every piece the launcher carves, the walks of every block are the tiers its
elements ask for, the two-level quantization with shared row maxima is the
oracle's bit for bit, and a test-side emulation of the walks in the plan's
tiling and k order is held against the plain version (integer cells bit for
bit, f32 cells within ``TOL_CLEAN`` of max|C|), ``repro.kernels.ref``'s
oracle and, at K <= 1024 where its f32 sums of integers are exact, the Pallas
kernel run with ``interpret=True``.
"""

import importlib.util
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.precision_island import (
    precision_island as j_precision_island)
from repro_torch.kernels import _build
from repro_torch.kernels import precision_island as pmod
from repro_torch.kernels import quant_rows as qmod
from repro_torch.kernels import razor_matmul as rmod
from repro_torch.kernels import ref as tref
from repro_torch.kernels.precision_island import (launch_plan,
                                                  precision_island_plain)

SRC = (_build.CSRC_DIR / "precision_island.cu").read_text()
#: the tensor-core products, the TMA ring and its constants (shared with
#: razor_matmul.cu), and the quantization prologue
RING = (_build.CSRC_DIR / "tc_ring.cuh").read_text()
QUANT = (_build.CSRC_DIR / "quant_rows.cu").read_text()
#: the sources with every run of white space made one space
FLAT = " ".join(SRC.split())
QUANT_FLAT = " ".join(QUANT.split())

#: the tolerance chip_smoke.py holds f32 cells to (its TOL_CLEAN)
TOL_CLEAN = 1e-5
#: shared memory a block can use on an H100 (227 KB) and an SM's (228 KB)
_BLOCK_SMEM, _SM_SMEM = 232_448, 233_472

#: (M, K, N): phi4-mini-3.8b's four weights at a 256-row chunk, the JAX
#: tests' shapes, chip_smoke.py's ragged case, and edge cases
PLAN_SHAPES = [(256, 3072, 3072), (256, 3072, 1024), (256, 3072, 8192),
               (256, 8192, 3072), (256, 256, 256), (128, 256, 128),
               (96, 100, 80), (1, 1, 1), (24, 40, 200)]


def _constexpr(name, text):
    hit = re.search(rf"constexpr int {name} = (\w+);", text)
    assert hit, name
    return hit.group(1)


def _walk_of_tier(tier):
    """The walk that computes a cell of tier ``tier``, as the kernel's
    walk_of_tier: 0 (int4), 1 (int8), any other value 2 (f32, the oracle's
    "else" branch)."""
    return tier if tier in (0, 1) else 2


def test_plan_constants_are_the_cuda_sources():
    assert int(_constexpr("BM", RING)) == pmod.TILE_M == 64
    assert int(_constexpr("BN", RING)) == pmod.TILE_N == 64
    assert int(_constexpr("BK", RING)) == pmod.TILE_K == 64
    assert int(_constexpr("STAGES", RING)) == pmod.STAGES
    assert int(_constexpr("THREADS", RING)) + 32 == pmod.BLOCK_THREADS
    assert int(_constexpr("ROW", RING)) == pmod._ROW_BYTES
    assert int(_constexpr("K_PAD", RING)) == qmod.K_TILE
    # the int8 copies' padding is one contract: quant_rows.cu writes the
    # rows the products read with the shared header's K_PAD and alignment
    assert '#include "tc_ring.cuh"' in QUANT
    assert "using tc_ring::K_PAD;" in QUANT
    assert "using tc_ring::aligned16;" in QUANT
    assert "constexpr int K_PAD" not in QUANT
    assert "inline bool aligned16" not in QUANT
    assert int(_constexpr("WS_ALIGN", RING)) == pmod.WS_ALIGN
    assert int(_constexpr("WALKS", SRC)) == len(pmod.WALKS) == 3
    # the product's constants come from the shared header alone
    assert '#include "tc_ring.cuh"' in SRC
    for name in ("BM", "BN", "BK", "STAGES", "THREADS", "K_PAD", "WS_ALIGN"):
        assert f"constexpr int {name} =" not in SRC, name
    # the grid, the padding and the k loop, as LaunchPlan computes them
    for text in ("const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);",
                 "const int Kp = (K + K_PAD - 1) / K_PAD * K_PAD;",
                 "static constexpr int BYTES = L::A_BYTES + L::B_BYTES;",
                 "SMEM_BYTES = STAGES * BYTES + 1024;",
                 "for (int i = 0; i < p.k_tiles; ++i, ++g)"):
        assert text in FLAT, text
    assert "Problem p{M, N, K, (K + BK - 1) / BK," in " ".join(RING.split())
    # the workspace is carved in LaunchPlan.workspace_pieces' order
    carved = re.findall(r"w->(\w+) = reinterpret_cast<[\w ]+\*>\(take\(",
                        SRC)
    names = {"sa8": "scale_a8", "sb8": "scale_b8", "sa4": "scale_a4",
             "sb4": "scale_b4"}
    assert [names.get(c, c) for c in carved] == [
        p for p, _ in launch_plan(8, 8, 8, 8, 8,
                                  torch.float32).workspace_pieces()]
    # the tier word's bits: walk w of tier t, any other tier the f32 walk
    assert "return t == 0 ? 0 : (t == 1 ? 1 : 2);" in FLAT
    assert [_walk_of_tier(t) for t in (0, 1, 2, 3, -1, 7)] == [0, 1, 2, 2,
                                                               2, 2]
    # the quantization: level 127 where the word has bit 1 (tier 1), level
    # 7 where it has bit 0 (tier 0), both from one row maximum
    assert "{127.0f, 7.0f}, {2u, 1u}," in QUANT_FLAT


def test_tensor_core_walks_and_no_float_atomics():
    """Each walk on the tensor cores from the ring of tc_ring.cuh: int8
    tiles on wgmma (bf16 operands) or mma.sync (f32), float tiles on bf16
    wgmma or the 3xTF32 split; each f32 k-tile a fresh sum waited for and
    added to the register sum; copies by TMA; the prologue and the product
    from one launcher; no __dp4a, no CUDA-core product, no float atomics."""
    for text in ("wgmma_fence(); issue_bf16_tile<KFAST>(As, Bs, t); "
                 "wgmma_commit(); wgmma_wait<0>(); fence_regs(t);",
                 "tf32_tile<KFAST>(As, Bs, t, wr, wc, lane);",
                 "wgmma_fence(); issue_s8_tile(Qa, Qb, iacc); wgmma_commit();",
                 "s8_tile(Qa, Qb, iacc, wr, wc, lane);",
                 "for (int e = 0; e < 32; ++e) v[e] += t[e];",
                 "tma_float_tiles<T, KFAST>(", "tma_int_tiles(",
                 "float_tiles_by_hand<T, KFAST>(",
                 "v[e] = dequant(iacc[e], s_a, __ldg(sb + min(col, p.N - 1)));",
                 "tier_word_kernel<<<1, WORD_THREADS, 0, s>>>(",
                 "err = quant_rows_tiers_launch(a, M, K, Kp, sa_m, sa_k,",
                 "err = quant_rows_tiers_launch(b, N, K, Kp, sb_n, sb_k,"):
        assert text in FLAT, text
    for form in ("wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8",
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                 "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32",
                 "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                 "cp.async.bulk.tensor.2d"):
        assert form in RING, form
    for text in (SRC, RING):
        assert not re.findall(r"atomic\w*\(", text)
        assert "__dp4a" not in text and "fmaf(" not in text
    assert not (_build.CSRC_DIR / "tile_products.cuh").exists()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _build.CSRC_DIR.parents[2] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k,n", [(3072, 3072), (3072, 1024), (3072, 8192),
                                 (8192, 3072)], ids=str)
@pytest.mark.parametrize("elem", [2, 4])
def test_bound_counts_the_bytes_the_function_needs(k, n, elem):
    """``chip_smoke.py``'s precision_island and razor_matmul bound, at
    phi4-mini's weights (M 256, cells of 128), counts what the function
    moves: a and b read once, C (f32) written once, the per-cell bytes;
    no int8 copy (those are the kernels' design, not the function's)."""
    cs = _chip_smoke()
    m = 256
    cells = (m // 128) * (n // 128)
    t_ms, by = cs.integer_gemm_bound_ms(m, k, n, elem, 0.0, 4 * cells)
    assert by == "bytes"
    want = elem * (m * k + k * n) + 4 * m * n + 4 * cells
    assert t_ms == pytest.approx(1e3 * want / cs.HBM_BYTES_PER_S, rel=1e-12)
    t_ops, by = cs.integer_gemm_bound_ms(m, k, n, elem, 1.0, 0)
    assert (t_ops, by) == (1e3, "operations")


def test_kernels_line_sums_each_shapes_own_bound():
    """The kernels line's razor_matmul / precision_island entry sums each
    timed shape's own bound and names the kind that sets the larger part
    of the sum, beside each shape's kind."""
    cs = _chip_smoke()
    rows = [{"weight": w, "dtype": "bfloat16", "kernel_ms": 1.0,
             "plain_ms": 2.0, "library_ms": 0.5, "library": "torch.matmul",
             "bound_ms": t, "bound_by": by, "max_err": 0.0,
             "max_err_limit": 1.0}
            for w, t, by in (("wq/wo", 0.007, "operations"),
                             ("wk/wv", 0.003, "bytes"),
                             ("w1/wg", 0.018, "bytes"),
                             ("w2", 0.017, "bytes"))]
    rows.append(dict(rows[0], dtype="float32", bound_ms=9.0))
    entry = cs.path_entry("precision_island", "src", "file:1", rows, 4,
                          "max_err")
    assert entry["bound_ms"] == pytest.approx(0.045)
    assert entry["bound_by"] == "bytes"
    assert entry["bound_by_shape"] == {"wq/wo": "operations",
                                       "wk/wv": "bytes", "w1/wg": "bytes",
                                       "w2": "bytes"}


def test_int8_maps_are_encoded_once_a_workspace():
    """The int8 copies' four tensor maps depend on the workspace alone: the
    wrapper keeps a workspace a shape and stream and encodes its maps once
    (precision_island_int_maps); a call encodes only a's and b's float maps
    and copies the kept ones."""
    assert int(_constexpr("INT_MAPS", SRC)) * 128 == pmod._MAPS_BYTES
    assert "static_assert(sizeof(CUtensorMap) == 128," in SRC
    head, launch = SRC.split('extern "C" int precision_island_launch(')
    maps_fn = head.split('extern "C" int precision_island_int_maps(')[1]
    assert "encode_int_maps(w, M, N, Kp, q)" in maps_fn
    assert "std::memcpy(maps, q, sizeof q);" in maps_fn
    assert "std::memcpy(q, int_maps, sizeof q);" in launch
    for encode in ("int_map(", "encode_int_maps(", "encode("):
        assert encode not in launch, encode
    product = FLAT.split("int launch_product(")[1].split("} // namespace")[0]
    assert "float_maps<T>(&map_a, &map_b," in product
    assert "int_map(" not in product
    assert pmod._workspace.cache_info().maxsize == pmod._WORKSPACES >= 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_grids_cover_the_output_and_each_walk_k_once(m, k, n, dtype):
    plan = launch_plan(m, n, k, 1, 1, dtype)
    assert plan.row_tiles * pmod.TILE_M >= m > (plan.row_tiles - 1) * 64
    assert plan.col_tiles * pmod.TILE_N >= n > (plan.col_tiles - 1) * 64
    # every walk's k-tiles cover K, and the zero-padded int8 rows, once
    assert plan.k_tiles * pmod.TILE_K >= plan.kp >= k
    assert plan.kp > (plan.k_tiles - 1) * pmod.TILE_K
    assert plan.kp % qmod.K_TILE == 0 and plan.kp == qmod.padded_k(k)
    assert plan.col_tiles <= pmod._MAX_GRID_Y


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_stage_fits_and_is_no_larger_than_razor_matmuls(dtype):
    """A stage holds one walk's operands: the float tiles of a and b (an
    int8 stage, 8 KB, fits inside).  It is no larger than razor_matmul's
    stage (both operands and both int8 copies), and at bf16 two blocks (and
    three) share an SM."""
    plan = launch_plan(256, 8192, 3072, 128, 128, dtype)
    es = 2 if dtype == torch.bfloat16 else 4
    float_bytes = 2 * 64 * 64 * es
    int_bytes = 2 * 64 * 64
    assert plan.stage_bytes == float_bytes >= int_bytes
    assert plan.stage_bytes < float_bytes + int_bytes      # razor_matmul's
    assert plan.smem_bytes == pmod.STAGES * plan.stage_bytes + 1024
    assert plan.smem_bytes <= _BLOCK_SMEM
    if dtype == torch.bfloat16:
        assert 3 * plan.smem_bytes <= _SM_SMEM


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_workspace_holds_every_piece_aligned(m, k, n):
    plan = launch_plan(m, n, k, 1, 1, torch.bfloat16)
    total, off = plan.workspace_bytes(), 0
    for name, nbytes in plan.workspace_pieces():
        assert off % pmod.WS_ALIGN == 0, name
        off += -(-nbytes // pmod.WS_ALIGN) * pmod.WS_ALIGN
    assert off == total
    pieces = dict(plan.workspace_pieces())
    for level in ("8", "4"):
        assert pieces[f"qa{level}"] == m * plan.kp
        assert pieces[f"qb{level}"] == n * plan.kp
        assert pieces[f"scale_a{level}"] == 4 * m
        assert pieces[f"scale_b{level}"] == 4 * n
    assert pieces["word"] == 4 and pieces["amax_b"] == 4 * n


# ----------------------------------------------------------------- maps ----


def _ij(gm, gn, tiers=(0, 1, 2)):
    """chip_smoke.py's map: cell (i, j) at tiers[(i + j) % len(tiers)]."""
    i, j = np.meshgrid(np.arange(gm), np.arange(gn), indexing="ij")
    return np.asarray(tiers, np.int32)[(i + j) % len(tiers)]


def _loop_map(gn, seed, tiers):
    """A calibrated map of the precision-island loop: 2 x gn cells of 128,
    tiers drawn from ``tiers``."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.asarray(tiers, np.int32), size=(2, gn))


#: (name, M, N, tiers): the loop's aligned 128 x 128 cells at phi4-mini's
#: widths, chip_smoke.py's (i + j) % 3 maps, the JAX tests' maps, ragged
#: 3 x 5 on 96 x 80 (cells 32 x 16), one-tier maps, maps that lack a level,
#: and tier values the oracle sends to f32
MAPS = [
    ("loop w1/wg", 256, 8192, _loop_map(64, 0, (0, 2))),
    ("loop wq/wo", 256, 3072, _loop_map(24, 1, (0, 1, 2))),
    ("loop w2", 256, 3072, _loop_map(24, 2, (2, 0, 0))),
    ("(i+j)%3 w1/wg", 256, 8192, _ij(2, 64)),
    ("(i+j)%3 wk/wv", 256, 1024, _ij(2, 8)),
    ("jax sweep", 256, 256, np.array([[0, 1], [2, 0]], np.int32)),
    ("jax f32", 256, 256, np.array([[2, 2], [2, 2]], np.int32)),
    ("jax int4", 256, 256, np.array([[0, 0], [0, 0]], np.int32)),
    ("ragged 3x5", 96, 80, _ij(3, 5)),
    ("one tier int8", 128, 128, np.array([[1]], np.int32)),
    ("tiers {0, 2}", 256, 8192, _ij(2, 64, (0, 2))),
    ("tiers {2}", 256, 8192, _ij(2, 64, (2,))),
    ("tiers {1}", 256, 8192, _ij(2, 64, (1,))),
    ("other values", 96, 80, np.array([[3, 0, -1, 1, 9]] * 3, np.int32)),
]


def _element_walks(tiers, m, n):
    gm, gn = tiers.shape
    t = np.repeat(np.repeat(tiers, m // gm, 0), n // gn, 1)
    return np.vectorize(_walk_of_tier)(t)


def _block_walks(plan, tiers):
    """[row tile][column tile] -> the walks that block runs, as the
    kernel's prologue forms them: the walks of the cells [ci0, ci1] x
    [cj0, cj1] that its tile, clipped to the output, covers."""
    out = []
    for bi in range(plan.row_tiles):
        row0 = bi * pmod.TILE_M
        ci0 = row0 // plan.block_m
        ci1 = (min(row0 + pmod.TILE_M, plan.m) - 1) // plan.block_m
        row = []
        for bj in range(plan.col_tiles):
            col0 = bj * pmod.TILE_N
            cj0 = col0 // plan.block_n
            cj1 = (min(col0 + pmod.TILE_N, plan.n) - 1) // plan.block_n
            row.append({_walk_of_tier(int(tiers[i][j]))
                        for i in range(ci0, ci1 + 1)
                        for j in range(cj0, cj1 + 1)})
        out.append(row)
    return out


def test_block_walks_are_the_kernels_prologue():
    """_block_walks mirrors the kernel's prologue: the cell ranges a block
    reads and the block-uniform set of walks it forms from them."""
    for text in ("const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;",
                 "const int ci0 = row0 / tz.block_m, cj0 = col0 / tz.block_n;",
                 "const int ci1 = (min(row0 + BM, p.M) - 1) / tz.block_m;",
                 "const int cj1 = (min(col0 + BN, p.N) - 1) / tz.block_n;",
                 "for (int x = tid; x < (ci1 - ci0 + 1) * ncj; x += BLOCK) "
                 "need |= 1u << walk_of_tier(__ldg( tz.map + (long long)(ci0 "
                 "+ x / ncj) * tz.grid_n + cj0 + x % ncj));",
                 "if (!((walks >> w) & 1u)) continue;"):
        assert text in FLAT, text
    for bit in range(len(pmod.WALKS)):
        assert (f"(__syncthreads_or(need & {1 << bit}u) ? {1 << bit}u : 0u)"
                in FLAT)


@pytest.mark.parametrize("name,m,n,tiers", MAPS, ids=[x[0] for x in MAPS])
def test_block_walks_are_the_tiers_of_their_elements(name, m, n, tiers):
    plan = launch_plan(m, n, 64, m // tiers.shape[0], n // tiers.shape[1],
                       torch.bfloat16)
    walks = _block_walks(plan, tiers)
    elem = _element_walks(tiers, m, n)
    for bi in range(plan.row_tiles):
        for bj in range(plan.col_tiles):
            tile = elem[bi * 64:(bi + 1) * 64, bj * 64:(bj + 1) * 64]
            assert walks[bi][bj] == set(np.unique(tile).tolist()), (bi, bj)
    if plan.block_m % 64 == 0 and plan.block_n % 64 == 0:
        # aligned cells of 64 or more: exactly one walk a block, so an
        # integer block streams only b's 1-byte copy
        assert all(len(w) == 1 for row in walks for w in row)
    present = set(np.unique(elem).tolist())
    assert set().union(*(w for row in walks for w in row)) == present


# ----------------------------------------------------------- quantization --


def _quant_two_levels(x):
    """quant_rows.cu's two-level pass in numpy float32: one row maximum, a
    scale a level from it, then x * RN(1 / scale) rounded half to even
    unless it lies within 2^-14 of a half-integer, where the true division
    decides.  Returns {levels: (q, scale)} and the divisions taken."""
    amax = np.abs(x).max(axis=1)
    out, taken = {}, 0
    for levels in (127, 7):
        sc = np.maximum(amax, np.float32(1e-12)) / np.float32(levels)
        inv = np.float32(1.0) / sc
        y = x * inv[:, None]
        q = np.rint(y)
        near = np.abs(np.abs(y - q) - np.float32(0.5)) <= np.float32(2.0 ** -14)
        q = np.where(near, np.rint(x / sc[:, None]), q)
        out[levels] = (np.clip(q, -levels, levels).astype(np.int8), sc)
        taken += int(near.sum())
    return out, taken


def test_two_level_quantization_equals_the_oracles():
    """Both levels from one row maximum give quantize_sym_i8 and
    quantize_sym_i4 bit for bit: random rows (f32 and bf16 values), rows
    whose x / scale lands exactly on k + 1/2 at either level (round half to
    even), and rows built so x / scale falls within a few ulp of k + 1/2 for
    every k (where the reciprocal and the division could part)."""
    rng = np.random.default_rng(23)
    rows = [rng.standard_normal((64, 512)).astype(np.float32),
            torch.from_numpy(rng.standard_normal((64, 512)).astype(
                np.float32)).to(torch.bfloat16).float().numpy()]
    halves = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5, 6.5, -6.5]
    rows.append(np.array([[7.0] + halves, [127.0] + halves[:-1] + [100.5]],
                         np.float32))
    for levels in (127, 7):
        s0 = rng.uniform(0.5, 2.0, (128, 1)).astype(np.float32) * np.float32(
            2.0) ** rng.integers(-20, 20, (128, 1)).astype(np.float32)
        k = rng.integers(-levels, levels, (128, 1024)) + 0.5
        jitter = rng.integers(-8, 9, (128, 1024)) * 2.0 ** -20
        near = ((k + k * jitter) * s0).astype(np.float32)
        near[:, 0] = np.float32(levels) * s0[:, 0]         # amax: scale ~ s0
        rows.append(near)
    taken = 0
    for x in rows:
        got, n_div = _quant_two_levels(x)
        taken += n_div
        for levels, oracle in ((127, tref.quantize_sym_i8),
                               (7, tref.quantize_sym_i4)):
            q_ref, s_ref = oracle(torch.from_numpy(x))
            q, sc = got[levels]
            np.testing.assert_array_equal(q, q_ref.numpy())
            np.testing.assert_array_equal(sc.view(np.int32),
                                          s_ref.numpy()[:, 0].view(np.int32))
    # the ties row: half-integers went to even at both levels
    q7 = _quant_two_levels(rows[2])[0][7][0]
    assert q7[0, 1:5].tolist() == [0, 2, 2, 0]
    assert taken > 1000          # the adversarial rows do reach the division


# ------------------------------------------------------------ emulation ----


def _tf32(x):
    """cvt.rna.tf32.f32's rounding of finite f32 values: to a 10-bit
    mantissa, to nearest, ties away from zero (tc_ring.cuh's to_tf32)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulate(a, b, tiers, f32):
    """The kernels' function in their tiling and order, numpy: C (M, N).
    a (M, K), b (K, N) float32 arrays holding the operands' values; ``f32``:
    the operands are f32 (the 3xTF32 split).  Each walk is computed over
    the whole output in the plan's k order (its order does not depend on
    the block), then every block stores the elements of each walk it runs
    whose cell has that walk's tier; an element no walk stores stays NaN."""
    m, k = a.shape
    n = b.shape[1]
    gm, gn = tiers.shape
    plan = launch_plan(m, n, k, m // gm, n // gn,
                       torch.float32 if f32 else torch.bfloat16)
    tk = pmod.TILE_K
    qa, _ = _quant_two_levels(a)
    qb, _ = _quant_two_levels(np.ascontiguousarray(b.T))
    result = {}
    for w, levels in ((0, 7), (1, 127)):
        (ia, sa), (ib, sb) = qa[levels], qb[levels]
        ia = np.pad(ia, ((0, 0), (0, plan.kp - k))).astype(np.int64)
        ib = np.pad(ib, ((0, 0), (0, plan.kp - k))).astype(np.int64)
        acc = np.zeros((m, n), np.int64)
        for t in range(plan.k_tiles):        # k32 MMA steps, exact
            for s in range(t * tk, min((t + 1) * tk, plan.kp), 32):
                acc += ia[:, s:s + 32] @ ib[:, s:s + 32].T
        assert np.abs(acc).max() < 2 ** 31
        result[w] = ((acc.astype(np.int32).astype(np.float32) * sa[:, None])
                     * sb[None, :])
    acc = np.zeros((m, n), np.float32)
    for t in range(plan.k_tiles):            # a fresh sum a k-tile
        ks = slice(t * tk, min((t + 1) * tk, k))
        at, bt = a[:, ks], b[ks, :]
        if f32:
            ah, bh = _tf32(at), _tf32(bt)
            al, bl = _tf32(at - ah), _tf32(bt - bh)
            tile = (al.astype(np.float64) @ bh + ah.astype(np.float64) @ bl
                    + ah.astype(np.float64) @ bh)
        else:
            tile = at.astype(np.float64) @ bt.astype(np.float64)
        acc = (acc + tile.astype(np.float32)).astype(np.float32)
    result[2] = acc
    elem = _element_walks(tiers, m, n)
    c = np.full((m, n), np.nan, np.float32)
    stores = np.zeros((m, n), np.int32)
    for bi, row in enumerate(_block_walks(plan, tiers)):
        for bj, walks in enumerate(row):
            blk = (slice(bi * 64, (bi + 1) * 64), slice(bj * 64, (bj + 1) * 64))
            for w in sorted(walks):
                mine = elem[blk] == w
                c[blk][mine] = result[w][blk][mine]
                stores[blk][mine] += 1
    assert (stores == 1).all()               # each element stored once
    return c


#: (M, K, N, tiers): the JAX tests' shape and maps, the ragged case (cells
#: 32 x 16, K not a multiple of the k-tile), K = 1024 (the Pallas kernel's
#: f32 sums of integers still exact), a phi4-like map at K = 3072 (48
#: k-tiles), and maps that lack a level or hold one tier
EMU_CASES = [
    (256, 256, 256, np.array([[0, 1], [2, 0]], np.int32)),
    (256, 256, 256, np.array([[1, 1], [1, 2]], np.int32)),
    (96, 100, 80, _ij(3, 5)),
    (256, 1024, 256, np.array([[2, 0], [1, 2]], np.int32)),
    (128, 3072, 512, _ij(1, 4)),
    (128, 3072, 512, _ij(1, 4, (0, 2))),
    (128, 384, 128, np.array([[0]], np.int32)),
]


@pytest.mark.parametrize("case", range(len(EMU_CASES)))
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_emulated_walks_equal_the_plain_version(case, dtype):
    m, k, n, tiers = EMU_CASES[case]
    rng = np.random.default_rng(31 + case)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b[0, :n // 2] *= 40.0                       # outliers in half the columns
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    a, b = ta.float().numpy(), tb.float().numpy()     # the operands' values
    gm, gn = tiers.shape
    bm, bn = m // gm, n // gn
    c_ref = precision_island_plain(ta, tb, torch.from_numpy(tiers),
                                   block_m=bm, block_n=bn).numpy()
    c = _emulate(a, b, tiers, dtype == "f32")
    exact = np.repeat(np.repeat((tiers == 0) | (tiers == 1), bm, 0), bn, 1)
    np.testing.assert_array_equal(c[exact].view(np.int32),
                                  c_ref[exact].view(np.int32))
    lim = TOL_CLEAN * float(np.abs(c_ref).max())
    assert float(np.abs(c - c_ref)[~exact].max(initial=0.0)) <= lim
    # the f32 cells against the exact product of the same values
    exact_prod = a.astype(np.float64) @ b.astype(np.float64)
    assert float(np.abs(c - exact_prod)[~exact].max(initial=0.0)) <= \
        TOL_CLEAN * float(np.abs(exact_prod).max())
    if bm != bn:
        return
    # repro.kernels.ref's oracle (square cells): the integer cells bit for
    # bit, the f32 cells within TOL_CLEAN of max|C|
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    jt = jnp.asarray(tiers, jnp.int32)
    c_j = np.asarray(jref.precision_island(ja, jb, jt, block=bm))
    np.testing.assert_array_equal(c[exact].view(np.int32),
                                  c_j[exact].view(np.int32))
    assert float(np.abs(c - c_j)[~exact].max(initial=0.0)) <= lim
    if k > 1024 or bm % 128:
        return
    # the Pallas kernel at K <= 1024, at the JAX tests' tolerances: it
    # rounds a few quotients to the other side of a tie (relative Frobenius
    # 2e-2 a quantized cell, 4e-2 int4 on bf16), f32 cells to 1e-4
    c_pl = np.asarray(j_precision_island(ja, jb, jt, interpret=True))
    for i in range(gm):
        for j in range(gn):
            blk = (slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn))
            if _walk_of_tier(int(tiers[i, j])) == 2:
                np.testing.assert_allclose(c[blk], c_pl[blk], rtol=1e-4,
                                           atol=1e-4)
            else:
                num = np.linalg.norm(c[blk] - c_pl[blk])
                den = np.linalg.norm(c_pl[blk]) + 1e-9
                bound = 4e-2 if (tiers[i, j] == 0 and dtype == "bf16") \
                    else 2e-2
                assert num / den < bound, (i, j, num / den)


def test_integer_walks_stay_exact_past_two_to_the_24():
    """Operands whose int8 copies are all +-127 (+-7) over K = 8192: the
    partial sums of the k-tiles pass 2^24 (an f32 sum of them would round),
    and the int32 sum of the walk is the exact product, as the plain
    version's, at both levels."""
    k = 8192
    a = np.ones((2, k), np.float32)
    b = np.ones((k, 3), np.float32)
    b[::2, 1] = -1.0
    b[1, 2] = 0.5
    for tier in (0, 1):
        tiers = np.full((1, 1), tier, np.int32)
        c = _emulate(a, b, tiers, True)
        c_ref = precision_island_plain(torch.from_numpy(a),
                                       torch.from_numpy(b),
                                       torch.from_numpy(tiers), block_m=2,
                                       block_n=3).numpy()
        np.testing.assert_array_equal(c.view(np.int32), c_ref.view(np.int32))
    assert k * 127 * 127 > 2 ** 24 and k < rmod._MAX_K
