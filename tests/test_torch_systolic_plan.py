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
