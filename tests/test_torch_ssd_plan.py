"""The pass plan of the port's ``ssd_chunk`` kernel, and its arithmetic, on
the CPU.

One ``ssd_chunk`` call on the card is three CUDA kernels (a state pass over
(b, chunk, head group), a carry pass over (b, h, state slice), a scan pass
over (b, chunk, head group, 64-row tile)) sized by
:func:`repro_torch.kernels.ssd_chunk.pass_plan`.  Here, without a card: the
plan's constants are read back from the CUDA source, its grids cover every
unit of work once, and a test-side emulation of the three passes, with the
kernel's 3xTF32 rounding (hi = rna(a), lo = rna(a - hi), to a 10-bit
mantissa; lo.hi + hi.lo + hi.hi), is held against the plain version (1e-5 of
max|.|) and the Pallas kernel in interpret mode (3e-4, as
``tests/test_torch_ssm.py`` holds the plain version).
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_chunk as j_ssd_chunk
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_chunk as smod
from repro_torch.kernels.ssd_chunk import pass_plan, ssd_chunk_plain

SRC = (_build.CSRC_DIR / "ssd_chunk.cu").read_text()
#: the 3xTF32 products and the staging, shared with wkv6.cu
TF32 = (_build.CSRC_DIR / "tf32_tiles.cuh").read_text()
#: the source with every run of white space made one space
FLAT = " ".join(SRC.split())

#: (b, s, h, p, n, chunk): zamba2-2.7b's loss shape, chip_smoke.py's ragged
#: chunks and one step, the JAX tests' shapes, several chunk tiles, and head
#: groups that do not divide h
PLAN_SHAPES = [(2, 2048, 80, 64, 64, 64), (1, 100, 80, 64, 64, 100),
               (1, 1000, 80, 64, 64, 1000), (4, 1, 80, 64, 64, 1),
               (2, 64, 2, 16, 8, 16), (1, 96, 4, 32, 16, 32),
               (2, 32, 1, 8, 4, 8), (4, 1024, 80, 64, 64, 256),
               (4, 2048, 13, 32, 16, 64), (2, 4096, 80, 64, 64, 128)]


def _constexpr(name):
    hit = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert hit, name
    return hit.group(1)


def _eval_constexpr(name):
    """A constant of the CUDA source, its expression evaluated with the
    constants it names."""
    names = {k: int(_eval_constexpr(k)) for k in ("DMAX", "TILE", "LDA", "LDB")
             if k != name and k in _constexpr(name)}
    return eval(_constexpr(name), {}, names)   # noqa: S307 (our own source)


def test_plan_constants_are_the_cuda_sources():
    assert int(_constexpr("DMAX")) == smod._MAX_DIM == 64
    assert int(_constexpr("TILE")) == smod.TILE
    assert int(_constexpr("MAX_HEADS")) == smod.MAX_HEADS
    assert int(_constexpr("CARRY_ELEMS")) == smod.CARRY_ELEMS
    # a carry thread takes 4 neighbouring elements (one float4)
    assert int(_constexpr("THREADS")) * 4 == smod.CARRY_ELEMS
    # the launcher's grids, as PassPlan computes them
    for text in ("const long long groups = (H + G - 1) / G;",
                 "const long long t_tiles = (chunk + TILE - 1) / TILE;",
                 "((long long)N * P + CARRY_ELEMS - 1) / CARRY_ELEMS",
                 "ssd_chunk_state_kernel<<<dim3(unsigned(B * nc), "
                 "unsigned(groups)), THREADS, STATE_SMEM_BYTES, st>>>",
                 "const dim3 carry_grid(unsigned(B * H), unsigned(slices));",
                 "ssd_chunk_scan_kernel<<<dim3(unsigned(B * nc), "
                 "unsigned(groups), unsigned(t_tiles)), THREADS, "
                 "SCAN_SMEM_BYTES, st>>>",
                 "heads_per_block > MAX_HEADS"):
        assert text in FLAT, text
    # a block reads its own chunk only: rows c0 + (tile offset) + i, i < rows
    assert "c0 = c * ch" in SRC


def test_shared_memory_fits_the_blocks_per_sm_it_is_sized_for():
    """Two scan blocks and three state blocks on one SM (228 KB of shared
    memory, 1 KB kept per block); one block's dynamic part within the 227 KB
    a block may ask for.  The tiles' padded rows: 68 floats where a
    fragment reads [m][k] (banks 4g + t), 72 where it reads [k][j] (8t +
    g)."""
    assert _eval_constexpr("LDA") == smod._MAX_DIM + 4
    assert _eval_constexpr("LDB") == smod._MAX_DIM + 8
    scan = _eval_constexpr("SCAN_SMEM_BYTES")
    state = _eval_constexpr("STATE_SMEM_BYTES")
    assert scan == (4 * 64 * 68 + 2 * 64 * 72 + 5 * 64) * 4
    assert state == 3 * 64 * 72 * 4
    sm, per_block, static_state = 228 * 1024, 1024, 4 * 1024
    assert 2 * (scan + per_block) <= sm
    assert 3 * (state + static_state + per_block) <= sm
    assert max(scan, state) <= 232448
    assert "__launch_bounds__(THREADS, 2)\nssd_chunk_scan_kernel" in SRC
    assert "__launch_bounds__(THREADS, 3)\nssd_chunk_state_kernel" in SRC


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_grids_cover_every_unit_once(shape):
    b, s, h, p, n, chunk = shape
    plan = pass_plan(*shape)
    nc, g = plan.n_chunks, plan.heads_per_block
    assert 1 <= g <= min(smod.MAX_HEADS, h)
    state = {}
    for x in range(plan.state_grid[0]):
        for y in range(plan.state_grid[1]):
            for head in range(y * g, min((y + 1) * g, h)):
                key = (x // nc, x % nc, head)
                state[key] = state.get(key, 0) + 1
    assert len(state) == b * nc * h and set(state.values()) == {1}
    scan = {}
    for x in range(plan.scan_grid[0]):
        for y in range(plan.scan_grid[1]):
            for z in range(plan.scan_grid[2]):
                assert z * smod.TILE < chunk        # every tile holds rows
                for head in range(y * g, min((y + 1) * g, h)):
                    key = (x // nc, x % nc, head, z)
                    scan[key] = scan.get(key, 0) + 1
    assert len(scan) == b * nc * h * plan.row_tiles
    assert set(scan.values()) == {1}
    assert plan.row_tiles * smod.TILE >= chunk > (plan.row_tiles - 1) * smod.TILE
    bh, slices, _ = plan.carry_grid
    assert bh == b * h and slices * smod.CARRY_ELEMS >= n * p
    assert (slices - 1) * smod.CARRY_ELEMS < n * p
    assert plan.states_shape == (b, h, nc, n, p)
    assert plan.cum_shape == (b, s, h)
    assert max(plan.head_groups, plan.row_tiles) <= 65535


def test_heads_per_block_fill_the_card_before_they_share():
    """Blocks take more heads (sharing B, C and the scores) only while at
    least TARGET_BLOCKS blocks remain: zamba2's loss shape 8 heads a block,
    640 blocks a pass; a single ragged chunk one head a block."""
    loss = pass_plan(2, 2048, 80, 64, 64, 64)
    assert loss.heads_per_block == 8
    assert loss.state_grid == (64, 10, 1) and loss.scan_grid == (64, 10, 1)
    assert loss.carry_grid == (160, 4, 1)
    assert 4 * np.prod(loss.states_shape) == 83_886_080       # 84 MB
    assert pass_plan(1, 1000, 80, 64, 64, 1000).heads_per_block == 1
    assert pass_plan(1, 1000, 80, 64, 64, 1000).scan_grid == (1, 80, 16)
    for shape in PLAN_SHAPES:
        plan = pass_plan(*shape)
        blocks = plan.state_grid[0] * plan.state_grid[1]
        assert plan.heads_per_block == 1 or blocks >= smod.TARGET_BLOCKS
    with pytest.raises(ValueError, match="does not divide"):
        pass_plan(1, 100, 2, 8, 4, 64)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its phases run only as ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(1, 1000, 80, 64, 64, 1000),
                                   (1, 1000, 80, 64, 64, 384),
                                   (1, 2048, 4, 16, 16, 2048)], ids=str)
def test_bound_counts_the_products_the_function_needs(shape):
    """``chip_smoke.py``'s ssd_chunk bound, where operations set it, counts
    per chunk the score tile's lower triangle with its diagonal (the rest
    is masked away): n multiply-adds an entry for ``C B^T`` once per (b,
    chunk), p an entry for its product with x dt per head, plus ch n p each
    for the carried state's term and the state update; a last, shorter
    chunk counts its own triangle.  Two operations a multiply-add, at the
    TF32 rate over the 3xTF32 split."""
    cs = _chip_smoke()
    b, s, h, p, n, chunk = shape
    t_ms, by = cs.ssd_bound_ms(*shape)
    assert by == "operations"
    lengths = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    tri = [int(torch.tril(torch.ones(c, c)).sum()) for c in lengths]
    macs = b * sum(t * n + h * (t * p + 2 * c * n * p)
                   for t, c in zip(tri, lengths))
    want = 1e3 * cs.TF32_SPLIT_PASSES * 2 * macs / cs.PEAK_FLOPS["tf32"]
    assert t_ms == pytest.approx(want, rel=1e-12)
    # the whole tile, as counted before, is about 1.8x the triangle here
    if chunk == s == 1000:
        full = b * (s * chunk * n + h * (s * chunk * p + 2 * s * n * p))
        assert 1.75 < full / macs < 1.85


def test_the_products_are_3xtf32_on_the_tensor_cores():
    assert '#include "tf32_tiles.cuh"' in SRC
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in TF32
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in TF32
    assert "hi = to_tf32(x);" in TF32
    assert "lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));" in TF32
    calls = re.findall(r"mma_tf32\(acc\[si\]\[jj\], (\w+), (\w+)\[", TF32)
    assert calls == [("al", "bh"), ("ah", "bl"), ("ah", "bh")]
    # the four products: dS in the state pass; C S_in, the scores and W x dt
    # in the scan pass
    assert " ".join(SRC.split()).count("product_3xtf32(") == 4
    for text in (SRC, TF32):
        assert not re.findall(r"atomic\w*\(", text) and "__expf" not in text


# ------------------------------------------------- the passes, emulated ----


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10-bit mantissa) to nearest, ties away from
    zero, as the kernel's to_tf32 (and cvt.rna.tf32.f32) does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel takes it: 3xTF32, f32 sums."""
    ah = _tf32(a)
    al = _tf32(a - ah)
    bh = _tf32(b)
    bl = _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _three_passes(x, dt, A_log, B, C, D, state, chunk):
    """ssd_chunk as the three kernels compute it: the state pass (cum in
    order, dS per chunk over 64-row tiles), the carry pass, the scan pass
    (the scores once per (t, s) tile pair for every head; the sum starts
    from (C S_in) exp(cum))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc, T = s // chunk, smod.TILE
    E = smod.EXP_CLAMP
    a = -torch.exp(A_log)
    da = dt * a                                               # (b, s, h)
    cum = torch.cumsum(da.reshape(b, nc, chunk, h), dim=2)    # (b,nc,ch,h)
    xdt = (x * dt[..., None]).reshape(b, nc, chunk, h, p)
    xc = x.reshape(b, nc, chunk, h, p)
    Bc, Cc = B.reshape(b, nc, chunk, n), C.reshape(b, nc, chunk, n)
    tiles = [(r0, min(T, chunk - r0)) for r0 in range(0, chunk, T)]

    # state pass: dS = (B * tail)^T (x dt), accumulated over the row tiles
    tail = torch.exp(torch.clamp(cum[:, :, -1:] - cum, -E, E))
    dS = torch.zeros(b, nc, h, n, p)
    for r0, rows in tiles:
        sl = slice(r0, r0 + rows)
        Bt = Bc[:, :, sl, None, :] * tail[:, :, sl, :, None]  # (b,nc,r,h,n)
        dS = dS + _mm3(Bt.permute(0, 1, 3, 4, 2),
                       xdt[:, :, sl].permute(0, 1, 3, 2, 4))
    # carry pass
    dec = torch.exp(torch.clamp(cum[:, :, -1], -E, 0.0))      # (b, nc, h)
    S, S_in = state.clone(), []
    for c in range(nc):
        S_in.append(S)
        S = S * dec[:, c, :, None, None] + dS[:, c]
    S_in = torch.stack(S_in, dim=1)                            # (b,nc,h,n,p)
    # scan pass
    ec = torch.exp(torch.clamp(cum, -E, 0.0))
    y = torch.empty(b, nc, chunk, h, p)
    for ti, (t0, nt) in enumerate(tiles):
        tsl = slice(t0, t0 + nt)
        Ct = Cc[:, :, tsl]                                     # (b,nc,t,n)
        acc = _mm3(Ct[:, :, None], S_in) * ec[:, :, tsl].permute(
            0, 1, 3, 2)[..., None]                             # (b,nc,h,t,p)
        for s0, ns in tiles[:ti + 1]:
            ssl = slice(s0, s0 + ns)
            scores = _mm3(Ct, Bc[:, :, ssl].transpose(-1, -2))  # (b,nc,t,s)
            keep = (torch.arange(s0, s0 + ns)[None, :]
                    <= torch.arange(t0, t0 + nt)[:, None])
            decay = torch.exp(torch.clamp(
                cum[:, :, tsl, None] - cum[:, :, None, ssl], -E, E))
            W = torch.where(keep[:, :, None], scores[..., None] * decay,
                            torch.zeros(()))                   # (b,nc,t,s,h)
            acc = acc + _mm3(W.permute(0, 1, 4, 2, 3),
                             xdt[:, :, ssl].permute(0, 1, 3, 2, 4))
        y[:, :, tsl] = (acc.permute(0, 1, 3, 2, 4)
                        + D[:, None] * xc[:, :, tsl])
    return y.reshape(b, s, h, p), S


def _inputs(b, s, h, p, n, seed, state):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, p)).astype(np.float32) if state
          else np.zeros((b, h, n, p), np.float32))
    return x, dt, A_log, B, C, D, s0


def test_tf32_rounding_is_rna_and_the_split_keeps_f32():
    one = 1.0 + 2.0 ** -11                   # halfway between TF32 neighbours
    got = _tf32(torch.tensor([one, -one, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                              1.0 + 2.0 ** -10, 0.0, -0.0],
                             dtype=torch.float32))
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2.0 ** -10, 0.0, -0.0])
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32) * 100)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    for part in (hi, lo):                    # 13 low bits clear
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 64)).astype(np.float32))
    ref = (a.double() @ a.double().T)
    err3 = (_mm3(a, a.T).double() - ref).abs().max()
    err1 = (_tf32(a).double() @ _tf32(a).double().T - ref).abs().max()
    assert err3 < 1e-5 * ref.abs().max() < err1     # one pass would not do


@pytest.mark.parametrize("b,s,h,p,n,chunk,state", [
    (2, 64, 2, 16, 8, 16, False),            # the JAX tests' shapes
    (1, 96, 4, 32, 16, 32, False),
    (2, 32, 1, 8, 4, 8, False),
    (1, 32, 2, 8, 4, 8, True),               # nonzero state
    (1, 100, 2, 16, 8, 100, True),           # ragged: two tiles, 64 + 36
    (1, 128, 2, 64, 64, 64, True),           # one zamba2 slice: p = n = 64
], ids=lambda v: str(v))
def test_three_passes_match_the_plain_version_and_pallas(b, s, h, p, n,
                                                         chunk, state):
    args = _inputs(b, s, h, p, n, seed=s + h + n, state=state)
    targs = [torch.from_numpy(a) for a in args]
    y, S = _three_passes(*targs, chunk=chunk)
    y_ref, S_ref = ssd_chunk_plain(*targs, chunk=chunk)
    for got, want in ((y, y_ref), (S, S_ref)):
        assert torch.isfinite(got).all()
        lim = 1e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= lim
    jy, jS = j_ssd_chunk(*[jnp.asarray(a) for a in args], chunk=chunk,
                         interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=3e-4,
                               atol=3e-4)
