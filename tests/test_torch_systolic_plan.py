"""The launch plan of the port's ``systolic_mac`` kernel, on the CPU.

The CUDA kernel splits K across the blocks of a cluster by
:func:`launch_plan`, which the wrapper computes in Python and hands to the
launcher.  Its contracts hold here without a card: the plan is a function of
(K, N, dtype) alone, so an element's order of summation never depends on M;
the splits' K ranges cover [0, K) once, in ascending order; the split-K
workspace (on chip) stays inside its bound.  The constants are read back
from the CUDA source, so the two cannot drift apart.  ``systolic_mac``'s
``counter=`` and the reference backend's running count are held against
the fresh count and the JAX reference.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import backend as tbackend
from repro_torch.kernels import _build
from repro_torch.kernels import systolic_mac as smod
from repro_torch.kernels.systolic_mac import launch_plan, systolic_mac

#: (K, N) of every weight the served models multiply by: phi4-mini-3.8b,
#: rwkv6-1.6b, zamba2-2.7b, seamless-m4t-medium, llama4-scout-17b-a16e
#: (its f32 router at N = 16), llava-next-mistral-7b and grok-1-314b's f32
#: router at N = 8 (chip_smoke.py's tables), plus ragged edges
MODEL_KN = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
            (3072, 200192), (2048, 2048), (2048, 32), (32, 2048),
            (2048, 7168), (7168, 2048), (2048, 65536), (2560, 10448),
            (5120, 2560), (2560, 2560), (2560, 10240), (10240, 2560),
            (2560, 32000),
            (1024, 1024), (1024, 4096), (4096, 1024), (1024, 256256),
            (5120, 5120), (5120, 1024), (5120, 8192), (8192, 5120),
            (5120, 16), (5120, 202240),
            (4096, 4096), (4096, 14336), (14336, 4096), (4096, 32000),
            (6144, 8)]
EDGE_KN = [(0, 1), (1, 1), (15, 7), (1000, 1001), (64, 128), (65, 129)]


@pytest.mark.parametrize("k,n", MODEL_KN + EDGE_KN)
@pytest.mark.parametrize("code", [0, 1])
def test_k_ranges_cover_k_once_in_ascending_order(k, n, code):
    plan = launch_plan(k, n, code)
    ranges = plan.k_ranges()
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2                       # contiguous, ascending
    for lo, hi in ranges:
        assert lo % plan.block_k == 0          # splits start on a k-tile
        # every split walks at least MIN_TILES_PER_SPLIT tiles when split
        assert plan.splits == 1 or (
            hi - lo > (smod.MIN_TILES_PER_SPLIT - 1) * plan.block_k)
    assert 1 <= plan.splits <= smod.MAX_SPLITS


def test_plan_takes_no_m_and_workspace_stays_in_its_bound():
    """M is not an argument of the plan, so no launch choice can follow it.
    The splits are a power of two up to the largest cluster (16 blocks), and
    the split-K workspace is one padded f32 partial tile per block in the
    cluster's shared memory: at most 16 x 8448 bytes an output tile, none
    in device memory."""
    assert list(inspect.signature(launch_plan).parameters) == [
        "k", "n", "dtype_code"]
    for k, n in MODEL_KN + EDGE_KN:
        for code in (0, 1):
            plan = launch_plan(k, n, code)
            assert plan.splits & (plan.splits - 1) == 0
            assert plan.splits <= smod.MAX_SPLITS == 16
            assert plan.splits <= max(1, plan.k_tiles)
            assert plan.workspace_bytes() <= smod.MAX_SPLITS * 8448
            assert (plan.workspace_bytes() == 0) == (plan.splits == 1)
            assert smod.PARTIAL_BYTES == smod.TILE_M * (smod.TILE_N + 4) * 4


def test_decode_shapes_split_and_logits_do_not():
    """Every served weight is cut into at most one block per SM (unless it
    cannot be cut less: one block per output tile), and into at least half
    as many blocks as the card has SMs where its K allows a split that
    large; the logits need no split."""
    for k, n in MODEL_KN:
        plan = launch_plan(k, n, 1)
        blocks = plan.n_tiles * plan.splits
        assert blocks <= smod.TARGET_BLOCKS or plan.splits == 1
        if n >= 32000:
            assert plan.splits <= 2
        if n >= 65536:
            assert plan.splits == 1
        k_cap = min(smod.MAX_SPLITS, plan.k_tiles // smod.MIN_TILES_PER_SPLIT)
        assert blocks * 2 > smod.TARGET_BLOCKS or plan.splits >= k_cap \
            or plan.splits == 1
    assert launch_plan(8192, 3072, 1).splits > 1            # phi4 w2
    assert launch_plan(10240, 2560, 1).splits > 1           # zamba2 w2


def test_plan_constants_are_the_cuda_sources():
    src = (_build.CSRC_DIR / "systolic_mac.cu").read_text()
    assert f"constexpr int BM = {smod.TILE_M};" in src
    assert f"constexpr int BN = {smod.TILE_N};" in src
    # a k-tile row is one 128-byte swizzle row: 64 bf16 or 32 f32
    assert "constexpr int ROW = 128;" in src
    assert "static constexpr int BK = ROW / ES;" in src
    assert smod.TILE_K == {0: 128 // 4, 1: 128 // 2}
    assert f"constexpr int MAX_SPLITS = {smod.MAX_SPLITS};" in src
    assert "constexpr int RED_LD = BN + 4;" in src
    # the split's tile range, as k_ranges computes it
    assert "(long long)split * k_tiles / splits" in src
    assert "(long long)(split + 1) * k_tiles / splits" in src
    # bf16 on the tensor cores at every M, f32 on fmaf, no float atomics
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "cp.async.bulk.tensor.2d.shared::cluster.global" in src
    assert "fmaf" in src
    assert "ld.shared::cluster.f32" in src
    # the only atomic is the integer count
    assert re.findall(r"atomic\w+\([^,]+", src) == ["atomicAdd(count"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counted_adds_into_the_running_count(dtype):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((8, 24)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((24, 8)).astype(np.float32))
    a, b = a.to(dtype), b.to(dtype)
    v_map = torch.from_numpy(rng.uniform(0.6, 1.0, (4, 4)).astype(np.float32))
    v_safe = torch.full((4, 4), 0.8)
    c, flags, count = systolic_mac(a, b, v_map, v_safe, count_flags=True)
    counter = torch.full((), 3, dtype=torch.int32)
    c2, flags2 = systolic_mac(a, b, v_map, v_safe, counter=counter)
    assert torch.equal(c, c2) and torch.equal(flags, flags2)
    assert int(counter) == 3 + int(count) and 0 < int(count) < 16
    # the oracle's product and flags
    c_ref, f_ref = jref.systolic_mac(
        jnp.asarray(a.float().numpy()).astype(jnp.dtype(str(dtype)[6:])),
        jnp.asarray(b.float().numpy()).astype(jnp.dtype(str(dtype)[6:])),
        jnp.asarray(v_map.numpy()), jnp.asarray(v_safe.numpy()), block=2)
    np.testing.assert_array_equal(flags2.numpy(), np.asarray(f_ref))
    # the kernels' tolerance for this test file's products: the same f32
    # operands summed in another order, corrupted cells masked alike
    np.testing.assert_allclose(c2.numpy(), np.asarray(c_ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bad", ["int64", "1-d", "both", "device"])
def test_counter_is_checked_before_any_launch(bad):
    """A counter the kernel could not add into raises ValueError: the wrong
    type or rank, together with count_flags=True, or on another device than
    the operands (the kernel would write through a foreign pointer)."""
    a, b = torch.ones(4, 64), torch.ones(64, 128)
    v = torch.ones(1, 1)
    counter = torch.zeros((), dtype=torch.int32)
    kw = {}
    if bad == "int64":
        counter = counter.to(torch.int64)
    elif bad == "1-d":
        counter = counter.reshape(1)
    elif bad == "both":
        kw["count_flags"] = True
    else:                   # CUDA-looking operands, a CPU counter
        a, b, v = (x.as_subclass(_CudaLooking) for x in (a, b, v))
    with pytest.raises(ValueError):
        systolic_mac(a, b, v, v, counter=counter, **kw)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_reference_route_hands_its_running_count_to_cuda_gemms(monkeypatch):
    """The reference backend's routed GEMMs add into one running count on
    the operands' device (no per-GEMM addition by the router), settled once
    by pop_telemetry."""
    from repro_torch.backend import impls
    seen = []

    def kernel(a, b, v_map, v_safe, *, block_m, block_n, counter):
        seen.append(counter)
        counter += 2
        return torch.zeros(a.shape[0], b.shape[1]), None

    monkeypatch.setattr(impls, "systolic_mac", kernel)
    be = impls.ReferenceBackend(device="cpu")
    monkeypatch.setattr(be, "_nominal", lambda grid, dev: (None, None))
    # the count the router made at the step's first GEMM
    running = torch.zeros((), dtype=torch.int32).as_subclass(_CudaLooking)
    be._deferred_flags = running
    x = torch.ones(2, 8).as_subclass(_CudaLooking)
    w = torch.ones(8, 4).as_subclass(_CudaLooking)
    with tbackend.use_backend(be):
        be.traced_matmul(x, w)
        be.traced_matmul(x, w)
    assert len(seen) == 2 and seen[0] is seen[1] is running
    assert be._deferred_flags is running and be.total.calls == 2
    tel = be.pop_telemetry()
    assert tel.calls == 2 and tel.flags == 4 and be._deferred_flags is None
    monkeypatch.undo()
    # CPU tensors: the same running count, on the CPU
    be = tbackend.get_backend("reference", device="cpu")
    with tbackend.use_backend(be):
        tbackend.matmul(torch.ones(2, 8), torch.ones(8, 4))
        tbackend.matmul(torch.ones(2, 8), torch.ones(8, 4))
    assert be._deferred_flags.device.type == "cpu"
    assert int(be._deferred_flags) == 0 and be.pop_telemetry().calls == 2


@pytest.mark.parametrize("counted", [False, True])
def test_cuda_tensors_raise_without_nvcc(counted, monkeypatch, tmp_path):
    """A CUDA tensor goes to the kernel or raises: with no compiler the
    wrapper raises the build's error and never takes the plain version."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)

    def plain(*args, **kw):
        raise AssertionError("the plain version served a CUDA tensor")

    monkeypatch.setattr(smod, "systolic_mac_plain", plain)
    a = torch.zeros(4, 64).as_subclass(_CudaLooking)
    b = torch.zeros(64, 128).as_subclass(_CudaLooking)
    v = torch.ones(1, 1).as_subclass(_CudaLooking)
    with pytest.raises(_build.KernelCompileError):
        if counted:
            systolic_mac(a, b, v, v, counter=torch.zeros(
                (), dtype=torch.int32).as_subclass(_CudaLooking))
        else:
            systolic_mac(a, b, v, v, count_flags=True)


# ---- the wide form (bf16 at large M) ---------------------------------------

def _constexpr(name, src):
    hit = re.search(rf"constexpr int {name} =\s*([^;]+);", src)
    assert hit, name
    return hit.group(1)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 63, 64, 127, 128, 129, 512,
                               1000, 2944, 2945])
def test_row_tile_by_m_and_dtype(m):
    """bf16 takes the wide form from WIDE_FROM_M rows on and the 16-row form
    below (a decode step's M = 1..16 always); f32 the 16-row form at every
    M.  The plan, and so every element's order of summation, is the same
    whichever form runs."""
    assert smod.row_tile(m, 0) == smod.TILE_M
    wide = m >= smod.WIDE_FROM_M
    assert smod.row_tile(m, 1) == (smod.WIDE_TILE_M if wide else smod.TILE_M)
    assert 16 < smod.WIDE_FROM_M <= 256
    assert list(inspect.signature(smod.row_tile).parameters) == [
        "m", "dtype_code"]


def test_launch_rows_routes_before_the_launch():
    """The row tile a call launches is decided from the operands alone: the
    wide form for bf16 operands the tensor maps take (both layouts of b),
    the 16-row form for f32, small M, a K of 0 and bases or row strides off
    16 bytes (which the 16-row form loads by hand)."""
    big = smod.WIDE_FROM_M * 4
    a = torch.zeros(big, 3072 + 8, dtype=torch.bfloat16)
    b = torch.zeros(3072 + 8, 1024 + 8, dtype=torch.bfloat16)
    table = torch.zeros(1024 + 8, 3072 + 8, dtype=torch.bfloat16)
    wide, row16 = smod.WIDE_TILE_M, smod.TILE_M
    aa, bb = a[:, :3072], b[:3072, :1024]
    assert smod.launch_rows(aa, bb) == wide
    assert smod.launch_rows(aa, table[:1024, :3072].T) == wide
    assert smod.launch_rows(aa[:16], bb) == row16          # a decode step
    assert smod.launch_rows(aa.float(), bb.float()) == row16
    assert smod.launch_rows(a[:, 1:3073], bb) == row16     # base off 16 B
    assert smod.launch_rows(aa, b[1:3073, 1:1025]) == row16
    assert smod.launch_rows(aa, table[1:1025, 1:3073].T) == row16
    odd = torch.zeros(big, 65, dtype=torch.bfloat16)       # row stride 130 B
    assert smod.launch_rows(odd, torch.zeros(65, 128,
                                             dtype=torch.bfloat16)) == row16
    assert smod.launch_rows(torch.zeros(big, 0, dtype=torch.bfloat16),
                            torch.zeros(0, 128, dtype=torch.bfloat16)) == row16


def test_wide_constants_are_the_cuda_sources():
    """The wide form's tile, warps, ring and padded row, read back from the
    CUDA source; its shared memory (ring, the splits' f32 total, alignment
    slack and the ring's mbarriers; the finished tile is staged over the
    ring) fits the 232,448 bytes a block may hold, and the finished tile
    fits over the ring."""
    src = (_build.CSRC_DIR / "systolic_mac.cu").read_text()
    assert int(_constexpr("WM", src)) == smod.WIDE_TILE_M == 128
    assert int(_constexpr("W_THREADS", src)) == smod.WIDE_THREADS == 256
    assert _constexpr("W_BLOCK", src) == "W_THREADS + 32"
    assert int(_constexpr("W_STAGES", src)) == smod.WIDE_STAGES
    assert _constexpr("W_RED_LD", src) == "BN + 8"
    assert smod.WIDE_RED_LD == smod.TILE_N + 8
    assert _constexpr("W_A_BYTES", src) == "WM * ROW"
    assert _constexpr("W_STAGE_BYTES", src) == "W_A_BYTES + BN * ROW"
    assert smod.WIDE_STAGE_BYTES == (smod.WIDE_TILE_M + smod.TILE_N) * 128
    assert _constexpr("W_TOTAL_BYTES", src) == "WM * BN * 4"
    ring = smod.WIDE_STAGES * smod.WIDE_STAGE_BYTES
    total = smod.WIDE_TILE_M * smod.TILE_N * 4
    barriers = 2 * smod.WIDE_STAGES * 8
    assert ring + total + 1024 + barriers <= 232448
    assert smod.WIDE_TILE_M * smod.WIDE_RED_LD * 4 <= ring
    # one kernel name for both forms, the wide one bf16 only
    assert "template <typename T, bool KFAST, int ROWS>" in src
    assert 'static_assert(ROWS == WM && sizeof(T) == 2' in src
    # the split walk: k-tiles in order, the total in split order
    assert "int t_hi = static_cast<int>((long long)k_tiles / splits);" in src
    assert ("t_hi = static_cast<int>((long long)(split + 1) * k_tiles / "
            "splits);") in src
    assert ("*t = split == 0 ? make_float4(f[0], f[1], f[2], f[3])\n"
            "                            : make_float4(t->x + f[0], t->y + f[1],"
            ) in src
    # the k-tile's MMAs into a fresh fragment, added into the split's sum
    assert "acc[mi][g * 4 + j][x] += tacc[mi][j][x];" in src
    assert "mma_bf16(tacc[mi][2 * jp], af[kq][mi], bf[0], bf[1]);" in src
    assert "for (int kq = 0; kq < 4; ++kq) {" in src    # ascending k


# The wide form's index arithmetic in Python, line by line after
# csrc/systolic_mac.cu::wide_tile: which block, warp and lane hold an
# element, where it is staged, and which thread writes it to C.

def _wide_fragment_cells():
    """(r, cc) in the 128 x 128 tile of every (warp, lane, mi, nj, x) the
    MMA warps hold, as the staging stores write them."""
    warp, lane, mi, nj, x = np.meshgrid(np.arange(8), np.arange(32),
                                        np.arange(2), np.arange(8),
                                        np.arange(4), indexing="ij")
    wm, wn = (warp >> 1) * 32, (warp & 1) * 64
    r = wm + mi * 16 + (lane >> 2) + np.where(x & 2, 8, 0)
    cc = wn + nj * 8 + 2 * (lane & 3) + (x & 1)
    return r.ravel(), cc.ravel()


def _wide_epilogue_writes(m, n):
    """Every (row, col) of C the epilogue threads write, block by block."""
    tile, threads, bn = smod.WIDE_TILE_M, smod.WIDE_THREADS, smod.TILE_N
    rows, cols = [], []
    for bx in range(-(-m // tile)):
        for by in range(-(-n // bn)):
            row0, col0 = bx * tile, by * bn
            rows_valid, cols_valid = min(tile, m - row0), min(bn, n - col0)
            for tid in range(threads):
                cc = tid % bn
                if cc >= cols_valid:
                    continue
                r = np.arange(tid // bn, rows_valid, threads // bn)
                rows.append(row0 + r)
                cols.append(np.full(r.shape, col0 + cc))
    return np.concatenate(rows), np.concatenate(cols)


def _wide_k_walk(plan):
    """The consumer's k-tiles, split by split, as its loop walks them."""
    k_tiles, splits = plan.k_tiles, plan.splits
    walk, split, t_hi = [[]], 0, k_tiles // splits
    for i in range(k_tiles):
        walk[split].append(i)
        if i + 1 == t_hi and t_hi < k_tiles:
            split += 1
            t_hi = (split + 1) * k_tiles // splits
            walk.append([])
    return walk


def test_wide_fragments_cover_the_tile_once():
    r, cc = _wide_fragment_cells()
    cells = r * smod.TILE_N + cc
    assert np.array_equal(np.sort(cells), np.arange(128 * 128))
    # float2 stores: each lane's pair is two neighbouring columns
    assert np.all(cc.reshape(-1, 2)[:, 1] == cc.reshape(-1, 2)[:, 0] + 1)


@pytest.mark.parametrize("m", [129, 1000, 2945])
def test_wide_epilogue_writes_every_element_once(m):
    n = 1001
    rows, cols = _wide_epilogue_writes(m, n)
    assert rows.max() < m and cols.max() < n
    hits = np.bincount(rows * n + cols, minlength=m * n)
    assert np.all(hits == 1)


@pytest.mark.parametrize("k,n", MODEL_KN + [(65, 1001), (1000, 1001),
                                            (65, 129)])
def test_wide_walk_is_the_plans_split_order(k, n):
    """The wide block walks the same k-tiles in the same splits as the
    16-row form's cluster (k_ranges), whatever M is."""
    plan = launch_plan(k, n, 1)
    walk = _wide_k_walk(plan)
    assert len(walk) == plan.splits
    assert [i for w in walk for i in w] == list(range(plan.k_tiles))
    ranges = [(w[0] * plan.block_k, min(k, (w[-1] + 1) * plan.block_k))
              for w in walk]
    assert ranges == plan.k_ranges()


def _tile_sums(a, b, block_k):
    """A k-tile's fresh four-MMA sum for every element, one array a tile
    (f32, 16 deep at a time: the emulation both forms share)."""
    k = a.shape[1]
    out = []
    for k0 in range(0, k, block_k):
        t = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for kk in range(k0, min(k, k0 + block_k), 16):
            t = t + (a[:, kk:kk + 16] @ b[kk:kk + 16]).astype(np.float32)
        out.append(t)
    return out


@pytest.mark.parametrize("k,n", [(65, 1001), (1024, 1001), (3072, 200)])
def test_wide_sums_in_the_16_row_forms_order(k, n):
    """Given the same per-tile sums, the wide form's order (the split's
    register sum, total = S0, total += S1, ..., the last split added at the
    end) gives the 16-row form's bits (v = part[0]; v += part[s]) for every
    element, -0.0 included."""
    rng = np.random.default_rng(30)
    m = 129
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    b[:, :3] = 0.0                              # some -0.0 / +0.0 sums
    a[:2] = -0.0
    plan = launch_plan(k, n, 1)
    tiles = _tile_sums(a, b, plan.block_k)
    # the 16-row form: each split in its block, summed in split order
    parts = []
    for lo, hi in plan.k_ranges():
        acc = np.zeros((m, n), np.float32)
        for t in range(lo // plan.block_k, -(-hi // plan.block_k)):
            acc = acc + tiles[t]
        parts.append(acc)
    v = parts[0]
    for p in parts[1:]:
        v = v + p
    # the wide form: one walk, the total in shared memory
    acc = np.zeros((m, n), np.float32)
    total = None
    for s, walk in enumerate(_wide_k_walk(plan)):
        for t in walk:
            acc = acc + tiles[t]
        if s + 1 < plan.splits:
            total = acc if s == 0 else total + acc
            acc = np.zeros((m, n), np.float32)
    wide = acc if plan.splits == 1 else total + acc
    assert plan.splits > 1 or k == 65
    np.testing.assert_array_equal(wide.view(np.int32), v.view(np.int32))
