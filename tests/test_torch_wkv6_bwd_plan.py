"""The launch plan of the port's ``wkv6`` backward kernels (f32 and bf16),
and the order of their sums, on the CPU.

One backward call on the card (``csrc/wkv6_bwd.cu``) is a state pass over
(b * h, chunk), a reverse carry over (b * h, state slice), one fused pass
over (b * h, chunk) where a chunk is one 64-row tile (else the first form's
row, column and lw passes) and a u pass, sized by
:func:`repro_torch.kernels.wkv6.pass_plan`.  Here, without a card: the
plan's constants and the launcher's workspace sum are read back from the
CUDA source, the shared memory fits the blocks an SM the source claims, the
grids cover every (b, h, chunk) once, and a test-side emulation of the fused
pass (3xTF32 products, or bf16 operands where the bf16 recurrence rounds;
ddec by rows of four threads; the column sums of the lw terms as two
row-strip halves; the reverse cumsum of d/dlw as lane pairs and a suffix
scan over the lanes) is held against ``wkv6_backward_plain`` within the
card's limits: 1e-4 of max|.| (1e-3 for du and dw_log) in f32, 2^-7 for dr,
dk, dv and dw_log in bf16.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as wmod
from repro_torch.kernels.wkv6 import pass_plan, wkv6_backward_plain

SRC = (_build.CSRC_DIR / "wkv6_bwd.cu").read_text()
#: the source with every run of white space made one space
FLAT = " ".join(SRC.split())
#: the card's limits (chip_smoke.py: TOL_RECURRENCE, TOL_REDUCED_GRAD,
#: TOL_WKV6_BF16)
TOL, TOL_REDUCED, TOL_BF16 = 1e-4, 1e-3, 2.0 ** -7
SM_BYTES, PER_BLOCK, BLOCK_MAX = 228 * 1024, 1024, 232448


def _constexpr(name):
    hit = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert hit, name
    return hit.group(1).strip()


def _eval(name):
    expr = _constexpr(name)
    names = {k: _eval(k) for k in re.findall(r"\b[A-Z][A-Z_]+\b", expr)}
    return eval(expr, {}, names)   # noqa: S307 (our own source)


def _smem(kind, elem):
    """The fused (or state) pass's dynamic shared memory for r/k/v of
    ``elem`` bytes, as the source's templates compute it."""
    ld_t = 72 if elem == 2 else 68
    if kind == "fused":
        return _eval("FUSED_TILES") * _eval("TILE_FLOATS") * 4 + 3 * 64 * ld_t * elem
    return 2 * 64 * _eval("LDB") * 4 + 64 * ld_t * elem


def test_backward_constants_are_the_cuda_source():
    assert _eval("PMAX") == wmod._MAX_P
    assert _eval("TILE") == wmod.TILE
    assert _eval("CARRY_ELEMS") == wmod.CARRY_ELEMS
    assert _eval("CARRY_UNROLL") == wmod.CARRY_UNROLL
    assert _eval("FUSED_TILES") == wmod.BWD_FUSED_TILES
    assert "EXP_CLAMP = 60.0f" in SRC
    for text in ("constexpr int LDT = IS_BF16<T> ? PMAX + 8 : PMAX + 4;",
                 "FUSED_TILES * TILE_FLOATS * 4 + 3 * TILE * LDT<T> * "
                 "(int)sizeof(T);",
                 "2 * TILE * LDB * 4 + TILE * LDT<T> * (int)sizeof(T);",
                 "const bool fused = chunk <= TILE;",
                 "wkv6_bwd_fused_kernel<T><<<dim3(bh, unsigned(nc)), THREADS, "
                 "FUSED_SMEM_BYTES<T>, st>>>",
                 "wkv6_bwd_state_kernel<T><<<dim3(bh, unsigned(nc)), THREADS, "
                 "STATE_SMEM_BYTES<T>, st>>>",
                 "const dim3 carry_grid(bh, unsigned(slices));",
                 "const dim3 tiles(bh, unsigned(nc), unsigned(n_tiles));",
                 "wkv6_bwd_du_kernel<<<unsigned(H), PMAX, 0, st>>>"):
        assert text in FLAT, text
    assert "for (int c1 = nc - 1; c1 >= 0; c1 -= CARRY_UNROLL)" in SRC
    assert SRC.count("cudaFuncSetAttribute(") == 4
    assert "if (done & bit) return cudaSuccess;" in SRC
    assert not re.findall(r"atomic\w*\(", SRC) and "__expf" not in SRC


def test_shared_memory_fits_the_blocks_per_sm_the_source_claims():
    """The fused pass: 9 padded f32 tiles and r, k, v (f32 at 68 a row, bf16
    at 72 halves), one block an SM; the state pass: lw_prev and dy at 64 x
    72 and r, three blocks an SM."""
    static = (4 * 2 * 64 + 5 * 64) * 4
    assert _smem("fused", 4) == 208896 and _smem("fused", 2) == 184320
    for elem in (4, 2):
        fused = _smem("fused", elem)
        assert fused + static <= BLOCK_MAX
        assert 2 * (fused + static + PER_BLOCK) > SM_BYTES    # one an SM
        assert 3 * (_smem("state", elem) + PER_BLOCK) <= SM_BYTES
    assert ("template <class T>\n__global__ void __launch_bounds__(THREADS, "
            "1)\nwkv6_bwd_fused_kernel") in SRC
    assert ("template <class T>\n__global__ void __launch_bounds__(THREADS, "
            "3)\nwkv6_bwd_state_kernel") in SRC
    assert "one block an SM" in FLAT


@pytest.mark.parametrize("shape", [
    (2, 2048, 32, 64, 64), (2, 256, 32, 64, 64), (1, 256, 32, 64, 64),
    (2, 256, 12, 47, 64), (2, 3, 12, 47, 1), (1, 1000, 32, 64, 1000),
    (2, 256, 12, 47, 128)], ids=str)
def test_grids_cover_every_head_and_chunk_once(shape):
    b, s, h, p, chunk = shape
    plan = pass_plan(*shape)
    assert plan.fused_backward == (chunk <= wmod.TILE)
    assert plan.backward_launches == (4 if plan.fused_backward else 6)
    x_, y_, z_ = plan.bwd_grid
    assert (x_, y_) == (b * h, plan.n_chunks)
    assert z_ == (1 if plan.fused_backward else plan.row_tiles)
    seen = {}
    for x in range(x_):
        for y in range(y_):
            for z in range(z_):
                for row in range(z * 64, min((z + 1) * 64, chunk)):
                    key = (x // h, x % h, y, row)
                    seen[key] = seen.get(key, 0) + 1
    assert len(seen) == b * h * s and set(seen.values()) == {1}


def _round4(n):
    return -(-n // 4) * 4


@pytest.mark.parametrize("shape", [(2, 2048, 32, 64, 64), (2, 3, 12, 47, 1),
                                   (1, 1000, 32, 64, 1000),
                                   (2, 256, 12, 47, 128)], ids=str)
def test_workspace_is_the_launchers_sum(shape):
    for text in ("const long long n_states = round4((long long)B * H * nc * "
                 "P * P);",
                 "const long long n_lw = round4((long long)B * S * H * P);",
                 "const long long n_part = round4((long long)B * H * nc * "
                 "n_tiles * P);",
                 "bws_floats < n_states + (fused ? n_part : n_lw + 4 * "
                 "n_part)"):
        assert text in FLAT, text
    b, s, h, p, chunk = shape
    nc, tiles = s // chunk, -(-chunk // 64)
    part = _round4(b * h * nc * tiles * p)
    want = _round4(b * h * nc * p * p) + (
        part if chunk <= 64 else _round4(b * s * h * p) + 4 * part)
    assert pass_plan(*shape).backward_workspace_floats == want
    assert "bws.data_ptr(), bws.numel()" in " ".join(
        open(wmod.__file__).read().split())


# ------------------------------------------ the fused pass, emulated ----


def _tf32(a):
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernels take it: 3xTF32, f32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _row_sums4(x):
    """row_sums: four threads a row over columns part, part + 4, ... in
    order, then (p0 + p1) + (p2 + p3)."""
    parts = []
    for part in range(4):
        acc = torch.zeros(x.shape[:-1])
        for q in range(part, x.shape[-1], 4):
            acc = acc + x[..., q]
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _col_total(z):
    """put_col_parts / col_total over a chunk's rows (dim -2): the rows of
    the warps with p = 0 (0-15, 48-63), then those with p = 1 (16-47)."""
    rows = torch.arange(z.shape[-2])
    first = (rows < 16) | (rows >= 48)
    zero = torch.zeros(())
    return (torch.where(first[:, None], z, zero).sum(-2)
            + torch.where(~first[:, None], z, zero).sum(-2))


def _suffix_rows(d):
    """The reverse cumsum over the rows (dim -2) as lane pairs and a
    Hillis-Steele suffix scan over 32 lanes."""
    ch = d.shape[-2]
    d = torch.nn.functional.pad(d, (0, 0, 0, 64 - ch))
    d0, d1 = d[..., 0::2, :], d[..., 1::2, :]
    incl = d0 + d1
    off = 1
    while off < 32:
        nxt = incl.clone()
        nxt[..., :32 - off, :] = incl[..., :32 - off, :] + incl[..., off:, :]
        incl, off = nxt, 2 * off
    after = torch.cat([incl[..., 1:, :], torch.zeros_like(incl[..., :1, :])],
                      -2)
    run = torch.stack([(d0 + d1) + after, d1 + after], -2)
    return run.reshape(d.shape)[..., :ch, :]


def _fused_backward(r, k, v, w_log, u, state, dy, dS_final, chunk, bf):
    """wkv6's backward as the state, carry, fused and u passes compute it
    where a chunk is one tile (chunk <= 64); ``bf``: the bf16 recurrence."""
    b, s, h, p = r.shape
    nc, E, f = s // chunk, wmod.EXP_CLAMP, torch.float32

    def rnd(x):
        return x.to(torch.bfloat16).to(f) if bf else x

    def mm_in(a, b_):                    # bf16 operands: exact products
        return rnd(a) @ rnd(b_) if bf else _mm3(a, b_)

    def lay(t):                          # (b, s, h, p) -> (b, nc, h, t, p)
        return t.to(f).reshape(b, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    rc, kc, vc = (rnd(lay(t)) for t in (r, k, v))
    dyc, lw = lay(dy), torch.cumsum(lay(w_log), 3)
    lp = torch.cat([torch.zeros_like(lw[..., :1, :]), lw[..., :-1, :]], 3)
    L = lw[..., -1:, :]
    ce = (lambda z, lo, hi: (torch.exp(torch.clamp(z, lo, hi)),
                             (z >= lo) & (z <= hi)))
    er, in_r = ce(lp - 0.5 * L, -E, E)
    ek, in_k = ce(0.5 * L - lw, -E, E)
    ers, in_s = ce(lp, -E, 0.0)
    tail, in_t = ce(L - lw, -E, E)
    dec, in_d = ce(L[..., 0, :], -E, 0.0)                     # (b,nc,h,p)
    rr, kk, kt = rnd(rc * rnd(er)), rnd(kc * rnd(ek)), kc * tail
    # the forward's scratch, the state pass and the carry
    S_c = _mm3(kt.transpose(-1, -2), vc)
    S, S_in = state.clone(), []
    for c in range(nc):
        S_in.append(S)
        S = S * dec[:, c, :, :, None] + S_c[:, c]
    S_in = torch.stack(S_in, 1)
    G = _mm3((rc * ers).transpose(-1, -2), dyc)
    dS = torch.zeros_like(S) if dS_final is None else dS_final.clone()
    dS_out = [None] * nc
    for c in range(nc - 1, -1, -1):
        dS_out[c] = dS
        dS = dS * dec[:, c, :, :, None] + G[:, c]
    dstate, dS_out = dS, torch.stack(dS_out, 1)
    # the fused pass
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool), -1)
    zero = torch.zeros(())
    uu = u.to(f)[:, None, :]
    ddiag = (dyc * vc).sum(-1, keepdim=True)
    diag = (rc * uu * kc).sum(-1, keepdim=True)
    ddec = _row_sums4(dS_out * S_in)                          # (b,nc,h,p)
    dA = torch.where(lower, rnd(mm_in(dyc, vc.transpose(-1, -2))), zero)
    A = torch.where(lower, rnd(mm_in(rr, kk.transpose(-1, -2))), zero)
    drs = _mm3(dyc, S_in.transpose(-1, -2))
    dkt = _mm3(vc, dS_out.transpose(-1, -2))
    dva = _mm3(kt, dS_out)
    drr = rnd(mm_in(dA, kk))
    dvi = mm_in(A.transpose(-1, -2), dyc)
    dkk = rnd(mm_in(dA.transpose(-1, -2), rr))
    if bf:
        dr = rnd(rnd(rnd(ers * drs) + rnd(ddiag * kc * uu)) + rnd(rnd(er) * drr))
        dk = rnd(rnd(rnd(dkt * tail) + rnd(ddiag * (rc * uu)))
                 + rnd(dkk * rnd(ek)))
        dv = rnd(rnd(rnd(dva) + rnd(diag * dyc)) + rnd(dvi))
    else:
        dr = (er * drr + ers * drs) + ddiag * uu * kc
        dk = (ek * dkk + tail * dkt) + ddiag * uu * rc
        dv = (dva + dvi) + diag * dyc
    zr = torch.where(in_r, rnd(rc * drr) * er, zero)
    zs = torch.where(in_s, rc * drs * ers, zero)
    zk = torch.where(in_k, rnd(kc * dkk) * ek, zero)
    zt = torch.where(in_t, kc * dkt * tail, zero)
    dL = ((torch.where(in_d, ddec * dec, zero)
           + 0.5 * (_col_total(zk) - _col_total(zr))) + _col_total(zt))
    g = zr + zs
    up = torch.cat([g[..., 1:, :], dL[..., None, :]], -2)
    dw = _suffix_rows((-zk - zt) + up)
    ut = _col_total(ddiag * rc * kc)                          # (b,nc,h,p)
    du = torch.zeros_like(u, dtype=f)
    for bi in range(b):                  # the partials in (batch, chunk) order
        for c in range(nc):
            du = du + ut[bi, c]
    cdt = torch.bfloat16 if bf else f
    back = (lambda t: t.permute(0, 1, 3, 2, 4).reshape(b, s, h, p))
    return (*(back(t).to(cdt) for t in (dr, dk, dv)), back(dw), du, dstate)


def _inputs(b, s, h, p, seed, state, bf):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(f) for _ in range(3))
    w_log = -np.exp(rng.standard_normal((b, s, h, p)) * 0.5 - 1).astype(f)
    u = rng.standard_normal((h, p)).astype(f)
    s0 = rng.standard_normal((b, h, p, p)).astype(f)
    dy = rng.standard_normal((b, s, h, p)).astype(f)
    dS = rng.standard_normal((b, h, p, p)).astype(f) if state else None
    rkv = [torch.from_numpy(t) for t in (r, k, v)]
    if bf:
        rkv = [t.to(torch.bfloat16) for t in rkv]
    return [*rkv, *(torch.from_numpy(t) for t in (w_log, u, s0, dy))], (
        None if dS is None else torch.from_numpy(dS))


@pytest.mark.parametrize("b,s,h,p,chunk,state,bf", [
    (2, 32, 2, 8, 16, False, False),     # the JAX tests' widths
    (1, 96, 3, 12, 32, True, False),     # odd widths, a partial lane pair
    (1, 128, 2, 16, 64, True, False),    # a 64-row chunk
    (2, 32, 2, 8, 16, True, True),       # the bf16 recurrence
    (1, 128, 2, 16, 64, False, True),
], ids=lambda v: str(v))
def test_fused_pass_orders_match_the_plain_version(b, s, h, p, chunk, state,
                                                   bf):
    args, dS = _inputs(b, s, h, p, seed=s + h + p, state=state, bf=bf)
    got = _fused_backward(*args, dS, chunk, bf)
    want = wkv6_backward_plain(*args, dS, chunk=chunk)
    names = ("dr", "dk", "dv", "dw_log", "du", "dstate")
    for name, gt, wt in zip(names, got, want):
        assert gt.shape == wt.shape and gt.dtype == wt.dtype, name
        assert torch.isfinite(gt.float()).all(), name
        if bf and name in ("dr", "dk", "dv", "dw_log"):
            tol = TOL_BF16
        else:
            tol = TOL_REDUCED if name in ("du", "dw_log") else TOL
        err = float((gt.float() - wt.float()).abs().max())
        assert err <= tol * float(wt.float().abs().max()), (name, err)
