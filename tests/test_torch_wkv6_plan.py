"""The pass plan of the port's ``wkv6`` kernels, and their arithmetic, on the
CPU.

One ``wkv6`` call on the card with chunks of more than one row is three CUDA
kernels (a state pass over (b * h, chunk), a carry pass over (b * h, state
slice), a scan pass over (b * h, chunk, 64-row tile)); a call with chunk 1
(decode) is one kernel over (b * h, 16-column slice of the state).
:func:`repro_torch.kernels.wkv6.pass_plan` sizes them.  Here, without a
card: the plan's constants are read back from the CUDA source, its grids
cover every unit of work once, and a test-side emulation of the three passes,
with the kernels' 3xTF32 rounding (hi = rna(a), lo = rna(a - hi), to a 10-bit
mantissa; lo.hi + hi.lo + hi.hi), is held against the plain version (1e-5 of
max|.|) and the Pallas kernel in interpret mode (2e-4, as
``tests/test_torch_ssm.py`` holds the plain version); the one-token formula
is held against the JAX package's per-token oracle.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as j_wkv6
from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as wmod
from repro_torch.kernels.wkv6 import pass_plan, wkv6_plain

SRC = (_build.CSRC_DIR / "wkv6.cu").read_text()
#: the 3xTF32 products and the staging, shared with ssd_chunk.cu
TF32 = (_build.CSRC_DIR / "tf32_tiles.cuh").read_text()
#: the source with every run of white space made one space
FLAT = " ".join(SRC.split())

#: (b, s, h, p, chunk): rwkv6-1.6b's loss shape, chip_smoke.py's ragged
#: chunks and decode steps, the JAX tests' shapes, odd head sizes and chunks
#: that are not a multiple of 64
PLAN_SHAPES = [(2, 2048, 32, 64, 64), (1, 100, 32, 64, 100),
               (1, 1000, 32, 64, 1000), (1, 1, 32, 64, 1), (4, 1, 32, 64, 1),
               (2, 64, 2, 16, 16), (1, 128, 3, 32, 32), (2, 32, 1, 8, 32),
               (1, 64, 2, 16, 16), (2, 256, 12, 47, 128), (3, 96, 5, 47, 1),
               (2, 192, 3, 47, 96), (1, 260, 2, 8, 130), (2, 6, 3, 32, 1)]


def _constexpr(name):
    hit = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert hit, name
    return hit.group(1)


def _eval_constexpr(name, bf16=None):
    """A constant of the CUDA source, its expression evaluated with the
    constants it names; a constant templated on the operand type
    (``IS_BF16<T> ? bf16 : f32``) at ``bf16``."""
    if bf16 is not None:
        hit = re.search(rf"template <class T>\nconstexpr int {name} =\s*"
                        rf"IS_BF16<T> \? ([^:]+) : ([^;]+);", SRC)
        assert hit, name
        expr = hit.group(1 if bf16 else 2).strip()
    else:
        expr = _constexpr(name)
    names = {k: int(_eval_constexpr(k))
             for k in ("PMAX", "TILE", "LDA", "LDB", "LDH")
             if k != name and re.search(rf"\b{k}\b", expr)}
    return eval(expr, {}, names)   # noqa: S307 (our own source)


def test_plan_constants_are_the_cuda_sources():
    assert int(_constexpr("PMAX")) == wmod._MAX_P == 64
    assert int(_constexpr("TILE")) == wmod.TILE
    assert int(_constexpr("CARRY_ELEMS")) == wmod.CARRY_ELEMS
    assert int(_constexpr("ONE_COLS")) == wmod.ONE_COLS
    # a carry thread takes 4 neighbouring elements (one float4), a one-token
    # thread one row's 4 columns: 64 rows x ONE_COLS / 4 threads
    assert int(_constexpr("THREADS")) * 4 == wmod.CARRY_ELEMS
    assert int(_constexpr("THREADS")) == wmod._MAX_P * wmod.ONE_COLS // 4
    assert "EXP_CLAMP = 60.0f" in SRC and wmod.EXP_CLAMP == 60.0
    # the launcher's grids and workspace, as PassPlan computes them
    for text in ("const dim3 grid(unsigned(B * H), unsigned((P + ONE_COLS - 1)"
                 " / ONE_COLS));",
                 "const long long t_tiles = (chunk + TILE - 1) / TILE;",
                 "((long long)P * P + CARRY_ELEMS - 1) / CARRY_ELEMS",
                 "const long long n_states = round4((long long)B * H * nc * P"
                 " * P);",
                 "const long long n_lw = round4((long long)B * S * H * P);",
                 "const long long n_dec = round4((long long)B * H * nc * P);",
                 "ws_floats < n_states + n_lw + n_dec",
                 "float* lw = states + n_states; float* dec = lw + n_lw;",
                 "nc > 65535 || t_tiles > 65535",
                 "wkv6_state_kernel<T><<<dim3(bh, unsigned(nc)), THREADS, "
                 "STATE_SMEM_BYTES<T>, st>>>",
                 "const dim3 carry_grid(bh, unsigned(slices));",
                 "wkv6_scan_kernel<T><<<dim3(bh, unsigned(nc), "
                 "unsigned(t_tiles)), THREADS, SCAN_SMEM_BYTES<T>, st>>>",
                 # the one-token kernel at chunk 1, but where the forward
                 # under autograd asks for the passes (wkv6_passes_launch)
                 "if (chunk == 1 && !passes) {",
                 "ws_floats, B, S, H, P, chunk, stream, true);"):
        assert text in FLAT, text
    # a block reads its own chunk only (the state pass and the scan pass's
    # two forms, f32 and bf16); the scan's last row tile first
    assert SRC.count("c0 = c * ch") == 3
    assert SRC.count("const int ti = gridDim.z - 1 - blockIdx.z") == 2


def test_shared_memory_fits_the_blocks_per_sm_it_is_sized_for():
    """Two scan blocks and three state blocks on one SM (228 KB of shared
    memory, 1 KB kept per block, the static arrays beside the dynamic
    tiles), for f32 and for bf16 r, k and v.  One block's dynamic part
    within the 227 KB a block may ask for.  The tiles' padded rows: 68
    floats where a fragment reads [m][k] (banks 4g + t), 72 where it reads
    [k][j] (8t + g); a bf16 tile's rows 72 halves."""
    assert _eval_constexpr("LDA") == wmod._MAX_P + 4
    assert _eval_constexpr("LDB") == wmod._MAX_P + 8
    assert _eval_constexpr("LDH") == wmod._MAX_P + 8
    scan = _eval_constexpr("SCAN_SMEM_BYTES", bf16=False)
    state = _eval_constexpr("STATE_SMEM_BYTES", bf16=False)
    assert scan == (4 * 64 * 68 + 2 * 64 * 72) * 4
    assert state == 3 * 64 * 72 * 4
    sm, per_block = 228 * 1024, 1024
    scan_static, state_static = 4 * 64 * 4, 64 * 4
    assert 2 * (scan + scan_static + per_block) <= sm
    assert 3 * (state + state_static + per_block) <= sm
    assert max(scan, state) <= 232448
    assert "__launch_bounds__(THREADS, 2)\nwkv6_scan_kernel" in SRC
    assert "__launch_bounds__(THREADS, 3)\nwkv6_state_kernel" in SRC
    # the bf16 forms: r, k, v, rr, kk and the scores in bf16 tiles
    scan16 = _eval_constexpr("SCAN_SMEM_BYTES", bf16=True)
    state16 = _eval_constexpr("STATE_SMEM_BYTES", bf16=True)
    assert scan16 == (2 * 64 * 68 + 64 * 72) * 4 + 4 * 64 * 72 * 2
    assert state16 == 64 * 72 * 4 + 2 * 64 * 72 * 2
    assert 2 * (scan16 + scan_static + per_block) <= sm
    assert 3 * (state16 + state_static + per_block) <= sm
    assert ("template <>\n__global__ void __launch_bounds__(THREADS, 2)\n"
            "wkv6_scan_kernel<__nv_bfloat16>(") in SRC
    # the one-token kernel: 16 KB of state a head, no dynamic tiles
    assert "wkv6_token_kernel<true><<<grid, THREADS, 0, st>>>" in FLAT


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_grids_cover_every_unit_once(shape):
    b, s, h, p, chunk = shape
    plan = pass_plan(*shape)
    nc = plan.n_chunks
    assert plan.one_token == (chunk == 1)
    if plan.one_token:
        bh, slices, one = plan.token_grid
        assert bh == b * h and one == 1
        cols = {}
        for x in range(bh):
            for y in range(slices):
                for q in range(y * wmod.ONE_COLS, (y + 1) * wmod.ONE_COLS):
                    if q < p:         # a block's slice does not depend on b
                        key = (x // h, x % h, q)
                        cols[key] = cols.get(key, 0) + 1
        assert len(cols) == b * h * p and set(cols.values()) == {1}
        assert (slices - 1) * wmod.ONE_COLS < p <= slices * wmod.ONE_COLS
        assert plan.workspace_floats == 0
        return
    state = {}
    for x in range(plan.state_grid[0]):
        for y in range(plan.state_grid[1]):
            key = (x // h, x % h, y)
            state[key] = state.get(key, 0) + 1
    assert len(state) == b * h * nc and set(state.values()) == {1}
    assert plan.state_grid[2] == 1
    scan = {}
    X, Y, Z = plan.scan_grid
    for x in range(X):
        for y in range(Y):
            for z in range(Z):
                ti = Z - 1 - z                  # the last row tile first
                assert ti * wmod.TILE < chunk   # every tile holds rows
                key = (x // h, x % h, y, ti)
                scan[key] = scan.get(key, 0) + 1
    assert len(scan) == b * h * nc * plan.row_tiles
    assert set(scan.values()) == {1}
    assert plan.row_tiles * wmod.TILE >= chunk > (plan.row_tiles - 1) * wmod.TILE
    bh, slices, _ = plan.carry_grid
    assert bh == b * h and slices * wmod.CARRY_ELEMS >= p * p
    assert (slices - 1) * wmod.CARRY_ELEMS < p * p
    assert plan.states_shape == (b, h, nc, p, p)
    assert plan.lw_shape == (b, s, h, p)
    assert plan.dec_shape == (b, h, nc, p)
    r4 = lambda n: -(-n // 4) * 4
    assert plan.workspace_floats == (r4(int(np.prod(plan.states_shape)))
                                     + r4(int(np.prod(plan.lw_shape)))
                                     + r4(int(np.prod(plan.dec_shape))))
    assert max(nc, plan.row_tiles) <= 65535


def test_loss_shape_plan():
    """rwkv6's loss shape: 2048 blocks in the state and scan passes (not the
    first version's 64), a 67 MB workspace (the 34 MB state scratch, the 34
    MB cumsum); a ragged chunk of 1000 spreads over 16 row tiles."""
    loss = pass_plan(2, 2048, 32, 64, 64)
    assert loss.state_grid == (64, 32, 1) and loss.scan_grid == (64, 32, 1)
    assert loss.carry_grid == (64, 4, 1)
    assert 4 * np.prod(loss.states_shape) == 33_554_432
    assert 4 * loss.workspace_floats == 67_633_152
    assert pass_plan(1, 1000, 32, 64, 1000).scan_grid == (32, 1, 16)
    assert pass_plan(4, 1, 32, 64, 1).token_grid == (128, 4, 1)
    with pytest.raises(ValueError, match="does not divide"):
        pass_plan(1, 100, 2, 8, 64)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its phases run only as ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(1, 1000, 32, 64, 1000),
                                   (1, 2048, 4, 16, 2048)], ids=str)
def test_bound_counts_the_products_the_function_needs(shape):
    """``chip_smoke.py``'s wkv6 bound, where operations set it, counts per
    chunk and head the score tile's strictly lower entries (the rest are
    masked away, and the scan skips the tiles above the diagonal) and their
    product with v, p multiply-adds each, plus ch p p each for ``S_c`` and
    the carried state's term: two operations a multiply-add, at the TF32
    rate over the 3xTF32 split."""
    cs = _chip_smoke()
    b, s, h, p, chunk = shape
    t_ms, by = cs.wkv6_bound_ms(*shape)
    assert by == "operations"
    lower = int(torch.tril(torch.ones(chunk, chunk), diagonal=-1).sum())
    macs = b * h * (s // chunk) * (2 * lower * p + 2 * chunk * p * p)
    want = 1e3 * cs.TF32_SPLIT_PASSES * 2 * macs / cs.PEAK_FLOPS["tf32"]
    assert t_ms == pytest.approx(want, rel=1e-12)


def test_the_products_are_3xtf32_on_the_tensor_cores():
    assert '#include "tf32_tiles.cuh"' in SRC
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in TF32
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in TF32
    assert "hi = to_tf32(x);" in TF32
    assert "lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));" in TF32
    calls = re.findall(r"mma_tf32\(acc\[si\]\[jj\], (\w+), (\w+)\[", TF32)
    assert calls == [("al", "bh"), ("ah", "bl"), ("ah", "bh")]
    # the four products: S_c in the state pass; r_state S_in, the scores and
    # A v in the scan pass
    assert FLAT.count("product_3xtf32(") == 1 + 3
    for text in (SRC, TF32):
        assert not re.findall(r"atomic\w*\(", text) and "__expf" not in text
        assert "fmaf" not in text


# ------------------------------------------------- the passes, emulated ----


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10-bit mantissa) to nearest, ties away from
    zero, as the kernels' to_tf32 (and cvt.rna.tf32.f32) does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: 3xTF32, f32 sums."""
    ah = _tf32(a)
    al = _tf32(a - ah)
    bh = _tf32(b)
    bl = _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _three_passes(r, k, v, w, u, state, chunk):
    """wkv6 as the three kernels compute it: the state pass (lw in row
    order, S_c over 64-row tiles), the carry pass, the scan pass (per row
    tile the sum starts from r_state S_in; the scores per s tile up to the
    row tile, strictly lower; the u bonus on the diagonal)."""
    b, s, h, p = r.shape
    nc, T, E = s // chunk, wmod.TILE, wmod.EXP_CLAMP
    rc, kc, vc, wc = (x.reshape(b, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
                      for x in (r, k, v, w))          # (b, nc, h, rows, p)
    lw = torch.cumsum(wc, dim=3)
    lend = lw[:, :, :, -1:]
    tiles = [(r0, min(T, chunk - r0)) for r0 in range(0, chunk, T)]

    # state pass: S_c = (k * tail)^T v, accumulated over the row tiles
    ktail = kc * torch.exp(torch.clamp(lend - lw, -E, E))
    S_c = torch.zeros(b, nc, h, p, p)
    for r0, rows in tiles:
        sl = slice(r0, r0 + rows)
        S_c = S_c + _mm3(ktail[..., sl, :].transpose(-1, -2), vc[..., sl, :])
    dec = torch.exp(torch.clamp(lend[..., 0, :], -E, 0.0))   # (b, nc, h, p)
    # carry pass
    S, S_in = state.clone(), []
    for c in range(nc):
        S_in.append(S)
        S = S * dec[:, c, :, :, None] + S_c[:, c]
    S_in = torch.stack(S_in, dim=1)                            # (b,nc,h,p,p)
    # scan pass
    lw_prev = torch.cat([torch.zeros_like(lw[..., :1, :]), lw[..., :-1, :]],
                        dim=3)
    m = 0.5 * lend
    rs = rc * torch.exp(torch.clamp(lw_prev, -E, 0.0))
    rr = rc * torch.exp(torch.clamp(lw_prev - m, -E, E))
    kk = kc * torch.exp(torch.clamp(m - lw, -E, E))
    diag = (rc * u[:, None] * kc).sum(-1, keepdim=True)       # (b,nc,h,ch,1)
    y = torch.empty(b, nc, h, chunk, p)
    for ti, (t0, nt) in enumerate(tiles):
        tsl = slice(t0, t0 + nt)
        acc = _mm3(rs[..., tsl, :], S_in)
        for s0, ns in tiles[:ti + 1]:
            ssl = slice(s0, s0 + ns)
            scores = _mm3(rr[..., tsl, :], kk[..., ssl, :].transpose(-1, -2))
            keep = (torch.arange(s0, s0 + ns)[None, :]
                    < torch.arange(t0, t0 + nt)[:, None])
            A = torch.where(keep, scores, torch.zeros(()))
            acc = acc + _mm3(A, vc[..., ssl, :])
        y[..., tsl, :] = acc + diag[..., tsl, :] * vc[..., tsl, :]
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p), S


def _one_token(r, k, v, w, u, state):
    """wkv6 at chunk 1 as the one-token kernel computes it, token by token:
    y = r S + (sum_p r u k) v, S' = S * exp(clip(w, -60, 0)) + k v^T."""
    S, ys = state.clone(), []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = (x[:, t] for x in (r, k, v, w))      # (b, h, p)
        ys.append(torch.einsum("bhp,bhpq->bhq", rt, S)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        S = (S * torch.exp(torch.clamp(wt, -wmod.EXP_CLAMP, 0.0))[..., None]
             + kt[..., None] * vt[..., None, :])
    return torch.stack(ys, dim=1), S


def _inputs(b, s, h, p, seed, decay=0.5, state=True, w_scale=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    w_log = (-np.exp(rng.standard_normal((b, s, h, p)) * decay)
             * w_scale).astype(np.float32)
    u = (rng.standard_normal((h, p)) * 0.1).astype(np.float32)
    s0 = ((rng.standard_normal((b, h, p, p)) * 0.1).astype(np.float32)
          if state else np.zeros((b, h, p, p), np.float32))
    return r, k, v, w_log, u, s0


def _close_to(got, want, frac):
    for g, w in zip(got, want):
        g, w = (torch.from_numpy(np.array(x)) for x in (g, w))
        assert torch.isfinite(g).all()
        lim = frac * float(w.abs().max())
        assert float((g - w).abs().max()) <= lim


def test_tf32_rounding_is_rna_and_the_split_keeps_f32():
    one = 1.0 + 2.0 ** -11                   # halfway between TF32 neighbours
    got = _tf32(torch.tensor([one, -one, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                              1.0 + 2.0 ** -10, 0.0, -0.0],
                             dtype=torch.float32))
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2.0 ** -10, 0.0, -0.0])
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 64)).astype(np.float32))
    ref = a.double() @ a.double().T
    err3 = (_mm3(a, a.T).double() - ref).abs().max()
    err1 = (_tf32(a).double() @ _tf32(a).double().T - ref).abs().max()
    assert err3 < 1e-5 * ref.abs().max() < err1     # one pass would not do


#: w_scale: the Pallas body multiplies its score tile by the mask, so where
#: a chunk's channel decays by more than about 110 (ROADMAP C6) the tile's
#: upper part overflows and inf * 0 gives NaN there; the rows held against
#: it keep their chunks' decays below that (a mean |w_log| of 0.34 over 100
#: rows).  The kernels and the plain version select, so the last row, with
#: the decays of chip_smoke.py's ragged case, is held against the plain
#: version alone.
@pytest.mark.parametrize("b,s,h,p,chunk,state,w_scale,pallas", [
    (2, 64, 2, 16, 16, True, 1.0, True),     # the JAX tests' shapes
    (1, 128, 3, 32, 32, True, 1.0, True),
    (2, 32, 1, 8, 32, True, 1.0, True),
    (1, 64, 2, 16, 16, False, 1.0, True),    # the chunked-form test's
    (1, 100, 2, 16, 100, True, 0.3, True),   # ragged: two tiles, 64 + 36
    (2, 192, 2, 47, 96, True, 0.3, True),    # p 47, a chunk of 64 + 32
    (1, 128, 2, 64, 64, True, 1.0, True),    # one rwkv6 head: p = 64
    (1, 200, 2, 64, 200, True, 1.0, False),  # four tiles, clamps binding
], ids=lambda v: str(v))
def test_three_passes_match_the_plain_version_and_pallas(b, s, h, p, chunk,
                                                         state, w_scale,
                                                         pallas):
    args = _inputs(b, s, h, p, seed=s + h + p, state=state, w_scale=w_scale)
    targs = [torch.from_numpy(a) for a in args]
    got = _three_passes(*targs, chunk=chunk)
    _close_to(got, wkv6_plain(*targs, chunk=chunk), 1e-5)
    if not pallas:
        return
    want = j_wkv6(*[jnp.asarray(a) for a in args], chunk=chunk,
                  interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("b,s,h,p", [(1, 1, 32, 64), (4, 1, 32, 64),
                                     (2, 5, 3, 47), (2, 8, 2, 16)],
                         ids=str)
def test_one_token_formula_matches_the_oracle(b, s, h, p):
    args = _inputs(b, s, h, p, seed=b * s + p)
    targs = [torch.from_numpy(a) for a in args]
    got = _one_token(*targs)
    _close_to(got, jref.wkv6(*[jnp.asarray(a) for a in args]), 1e-5)
    _close_to(got, wkv6_plain(*targs, chunk=1), 1e-5)
