"""The launch plan of the port's ``ssd_chunk`` backward kernels, and the
order of their sums, on the CPU.

One backward call on the card (``csrc/ssd_chunk_bwd.cu``) is a state pass
over (b, chunk, head group), a reverse carry over (b, h, state slice), one
fused pass over (b, chunk, head group) where a chunk is one 64-row tile
(else the first form's row, column and cumsum passes over (b * h, chunk,
row tile)) and one reduce pass, sized by
:func:`repro_torch.kernels.ssd_chunk.pass_plan`.  Here, without a card: the
plan's constants and the launcher's workspace sum are read back from the
CUDA source, the shared memory fits the blocks an SM the source claims, the
grids cover every (b, chunk, head) once, and a test-side emulation of the
fused pass, with the kernels' 3xTF32 products and its summation orders (each
group's dB and dC terms over its heads in order, then the groups in order;
ddec by rows, then a 32-lane tree; the reverse cumsum of d/dcum as lane
pairs and a suffix scan over the lanes), is held against
``ssd_chunk_backward_plain`` within the card's limits (1e-4 of max|.|, 1e-3
for dA_log and dD).
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd_chunk as smod
from repro_torch.kernels.ssd_chunk import pass_plan, ssd_chunk_backward_plain

SRC = (_build.CSRC_DIR / "ssd_chunk_bwd.cu").read_text()
#: the source with every run of white space made one space
FLAT = " ".join(SRC.split())
#: the card's limits (chip_smoke.py: TOL_RECURRENCE, TOL_REDUCED_GRAD)
TOL, TOL_REDUCED = 1e-4, 1e-3
#: shared memory of an SM, what the card keeps a block, what a block may ask
SM_BYTES, PER_BLOCK, BLOCK_MAX = 228 * 1024, 1024, 232448


def _constexpr(name):
    hit = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert hit, name
    return hit.group(1).strip()


def _eval(name):
    """A constant of the CUDA source, evaluated with the constants it
    names."""
    expr = _constexpr(name)
    names = {k: _eval(k) for k in re.findall(r"\b[A-Z][A-Z_]+\b", expr)}
    return eval(expr, {}, names)   # noqa: S307 (our own source)


def test_backward_constants_are_the_cuda_source():
    assert _eval("DMAX") == smod._MAX_DIM
    assert _eval("TILE") == smod.TILE
    assert _eval("MAX_HEADS") == smod.MAX_HEADS
    assert _eval("CARRY_ELEMS") == smod.CARRY_ELEMS
    assert _eval("CARRY_UNROLL") == smod.CARRY_UNROLL
    assert _eval("THREADS") == smod.THREADS
    assert _eval("BC_ROWS") == smod.BC_ROWS
    assert _eval("FUSED_TILES") == smod.BWD_FUSED_TILES
    assert "EXP_CLAMP = 30.0f" in SRC
    # the launcher's grids, as PassPlan computes them
    for text in ("const long long groups = (H + G - 1) / G;",
                 "const bool fused = chunk <= TILE;",
                 "const long long slots = fused ? groups : H;",
                 "const dim3 blocks(unsigned(B * nc), unsigned(groups));",
                 "ssd_bwd_state_kernel<<<blocks, THREADS, STATE_SMEM_BYTES, "
                 "st>>>",
                 "const dim3 carry_grid(bh, unsigned(slices));",
                 "ssd_bwd_fused_kernel<<<blocks, THREADS, FUSED_SMEM_BYTES, "
                 "st>>>",
                 "const dim3 tiles(bh, unsigned(nc), unsigned(n_tiles));",
                 "heads_per_block > MAX_HEADS",
                 "ssd_bwd_reduce_kernel<<<unsigned(bc_blocks + (H + THREADS "
                 "- 1) / THREADS),"):
        assert text in FLAT, text
    # the carry issues CARRY_UNROLL chunks' loads before it walks them
    assert "for (int c1 = nc - 1; c1 >= 0; c1 -= CARRY_UNROLL)" in SRC
    # the shared-memory limits are set once a device, not once a call
    assert SRC.count("cudaFuncSetAttribute(") == 4
    assert "if (done & bit) return cudaSuccess;" in SRC
    # no float atomics; accurate exponentials
    assert not re.findall(r"atomic\w*\(", SRC) and "__expf" not in SRC


def test_shared_memory_fits_the_blocks_per_sm_the_source_claims():
    """The fused pass: 11 padded 64 x 68 f32 tiles and the heads' cum and dt
    (dynamic), the row and column partials (static), one block an SM; the
    state pass: C and two dy buffers at 64 x 72, three blocks an SM."""
    fused, state = _eval("FUSED_SMEM_BYTES"), _eval("STATE_SMEM_BYTES")
    assert fused == (11 * 64 * 68 + 4 * 64) * 4 == 192512
    assert state == 3 * 64 * 72 * 4
    fused_static = (4 * 4 * 64 + 2 * 64 + 4 * 64) * 4 + 2 * 64
    state_static = 2 * 64 * 4
    assert fused + fused_static <= BLOCK_MAX
    assert 2 * (fused + fused_static + PER_BLOCK) > SM_BYTES   # one a SM
    assert 3 * (state + state_static + PER_BLOCK) <= SM_BYTES
    assert "__launch_bounds__(THREADS, 1)\nssd_bwd_fused_kernel" in SRC
    assert "__launch_bounds__(THREADS, 3)\nssd_bwd_state_kernel" in SRC
    assert "one block an SM (8" in FLAT


@pytest.mark.parametrize("shape", [
    (2, 2048, 80, 64, 64, 64), (2, 256, 80, 64, 64, 64),
    (1, 256, 80, 64, 64, 64), (2, 256, 12, 47, 37, 64),
    (1, 64, 12, 47, 37, 64), (2, 32, 1, 8, 4, 8), (1, 100, 80, 64, 64, 100),
    (2, 256, 12, 47, 37, 128)], ids=str)
def test_grids_cover_every_head_and_row_once(shape):
    b, s, h, p, n, chunk = shape
    plan = pass_plan(*shape)
    nc, g = plan.n_chunks, plan.heads_per_block
    assert plan.fused_backward == (chunk <= smod.TILE)
    assert plan.backward_launches == (4 if plan.fused_backward else 6)
    seen = {}
    if plan.fused_backward:
        x_, y_, z_ = plan.bwd_grid
        assert (x_, y_, z_) == plan.state_grid and z_ == 1
        assert plan.bc_slots == y_ == plan.head_groups
        for x in range(x_):
            for y in range(y_):
                for head in range(y * g, min((y + 1) * g, h)):
                    for row in range(chunk):     # a block: its chunk's rows
                        key = (x // nc, x % nc, head, row)
                        seen[key] = seen.get(key, 0) + 1
    else:
        x_, y_, z_ = plan.bwd_grid
        assert (x_, y_, z_) == (b * h, nc, plan.row_tiles)
        assert plan.bc_slots == h
        for x in range(x_):
            for y in range(y_):
                for z in range(z_):
                    for row in range(z * 64, min((z + 1) * 64, chunk)):
                        key = (x // h, y, x % h, row)
                        seen[key] = seen.get(key, 0) + 1
    assert len(seen) == b * nc * h * chunk and set(seen.values()) == {1}
    assert plan.partials_shape == (b, s, plan.bc_slots, n)
    bc_blocks = -(-b * s // smod.BC_ROWS)
    assert plan.reduce_grid == (bc_blocks + -(-h // smod.THREADS), 1, 1)
    assert bc_blocks * smod.BC_ROWS >= b * s


def test_head_groups_follow_the_forward_and_shrink_the_partials():
    """zamba2's loss shape: 8 heads a block, 640 blocks, 10 partials of dB
    and dC a row (21 MB, the first form's one a head 168 MB); the train
    shape 2 heads (320 blocks); at b 1 one head a block."""
    loss = pass_plan(2, 2048, 80, 64, 64, 64)
    assert loss.heads_per_block == 8 and loss.bwd_grid == (64, 10, 1)
    assert 2 * 4 * np.prod(loss.partials_shape) == 20_971_520
    assert 2 * 4 * 2 * 2048 * 80 * 64 == 167_772_160
    train = pass_plan(2, 256, 80, 64, 64, 64)
    assert train.heads_per_block == 2 and train.bwd_grid == (8, 40, 1)
    assert pass_plan(1, 256, 80, 64, 64, 64).heads_per_block == 1
    assert pass_plan(1, 1000, 80, 64, 64, 1000).bc_slots == 80


def _round4(n):
    return -(-n // 4) * 4


@pytest.mark.parametrize("shape", [(2, 2048, 80, 64, 64, 64),
                                   (1, 256, 12, 47, 37, 64),
                                   (1, 1000, 80, 64, 64, 1000),
                                   (2, 256, 12, 47, 37, 128)], ids=str)
def test_workspace_is_the_launchers_sum(shape):
    """The wrapper's scratch (``backward_workspace_floats``) is the sum the
    launcher refuses to go below, term for term."""
    for text in ("const long long n_states = round4((long long)B * H * nc * "
                 "NP);",
                 "const long long n_bsh = round4((long long)B * S * H);",
                 "const long long n_bc = round4((long long)B * S * slots * N);",
                 "const long long n_part = round4((long long)B * H * nc * "
                 "n_tiles);",
                 "const long long n_chunks = round4((long long)B * H * nc);",
                 "bws_floats < n_states + 2 * n_bsh + 2 * n_bc + 2 * n_part + "
                 "n_chunks"):
        assert text in FLAT, text
    b, s, h, p, n, chunk = shape
    plan = pass_plan(*shape)
    nc, tiles = s // chunk, -(-chunk // 64)
    slots = plan.head_groups if chunk <= 64 else h
    want = (_round4(b * h * nc * n * p) + 2 * _round4(b * s * h)
            + 2 * _round4(b * s * slots * n) + 2 * _round4(b * h * nc * tiles)
            + _round4(b * h * nc))
    assert plan.backward_workspace_floats == want
    # and the wrapper hands the launcher its workspace's length
    assert "bws.data_ptr(), bws.numel()" in " ".join(
        open(smod.__file__).read().split())


# ------------------------------------------ the fused pass, emulated ----


def _tf32(a):
    """float32 rounded to TF32 (10-bit mantissa), ties away from zero, as
    the kernels' to_tf32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernels take it: 3xTF32, f32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _lanes64(v):
    """A (..., rows <= 64) vector padded to the 64 rows two a lane."""
    return torch.nn.functional.pad(v, (0, 64 - v.shape[-1]))


def _warp_sum(v32):
    """warp_sum: a butterfly over 32 lanes (every lane ends with lane 0's
    value)."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v32 = v32 + v32[..., lane ^ off]
    return v32[..., 0]


def _row_sums4(x):
    """row_sums: four threads a row, each over the columns q = part, part +
    4, ... in order, then (p0 + p1) + (p2 + p3)."""
    parts = []
    for part in range(4):
        acc = torch.zeros(x.shape[:-1])
        for q in range(part, x.shape[-1], 4):
            acc = acc + x[..., q]
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _suffix(d):
    """The reverse cumsum over a chunk's rows as the fused pass takes it:
    lane l holds rows 2l and 2l + 1, their pair sum runs a Hillis-Steele
    suffix scan over the lanes, and each row adds the lanes after it."""
    d = _lanes64(d)
    d0, d1 = d[..., 0::2], d[..., 1::2]
    incl = d0 + d1
    off = 1
    while off < 32:
        nxt = incl.clone()
        nxt[..., :32 - off] = incl[..., :32 - off] + incl[..., off:]
        incl, off = nxt, 2 * off
    after = torch.cat([incl[..., 1:], torch.zeros_like(incl[..., :1])], -1)
    run = torch.stack([(d0 + d1) + after, d1 + after], -1)
    return run.reshape(d.shape)


def _fused_backward(x, dt, A_log, B, C, D, state, dy, dS_final, chunk, g):
    """ssd_chunk's backward as the state, carry, fused and reduce passes
    compute it where a chunk is one tile (chunk <= 64), ``g`` heads a
    group."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc, E = s // chunk, smod.EXP_CLAMP
    f = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).permute(0, 1, 3, 2, 4)     # bcht p
    dyc = dy.reshape(b, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)         # bcht
    Bc, Cc = B.reshape(b, nc, 1, chunk, n), C.reshape(b, nc, 1, chunk, n)
    a = -torch.exp(A_log)                                          # (h,)
    cum = torch.cumsum(dtc * a[:, None], -1)                       # bcht
    clampexp = (lambda z, lo, hi: (torch.exp(torch.clamp(z, lo, hi)),
                                   (z >= lo) & (z <= hi)))
    ec, e_in = clampexp(cum, -E, 0.0)
    L = cum[..., -1:]
    tail, t_in = clampexp(L - cum, -E, E)
    dec, in_d = clampexp(L[..., 0], -E, 0.0)                        # bch
    xdt = xc * dtc[..., None]
    # the forward's scratch: each chunk's incoming state
    S_c = _mm3((Bc * tail[..., None]).transpose(-1, -2), xdt)      # bchnp
    S, S_in = state.clone(), []
    for c in range(nc):
        S_in.append(S)
        S = S * dec[:, c, :, None, None] + S_c[:, c]
    S_in = torch.stack(S_in, 1)
    # state pass and reverse carry
    G = _mm3((Cc * ec[..., None]).transpose(-1, -2), dyc)
    dS = torch.zeros_like(S) if dS_final is None else dS_final.clone()
    dS_out = [None] * nc
    for c in range(nc - 1, -1, -1):
        dS_out[c] = dS
        dS = dS * dec[:, c, :, None, None] + G[:, c]
    dstate, dS_out = dS, torch.stack(dS_out, 1)
    # the fused pass, each head
    Q = _mm3(dyc, S_in.transpose(-1, -2))                          # t x n
    U = _mm3(xdt, dS_out.transpose(-1, -2))                        # s x n
    dxa = _mm3(Bc.expand(-1, -1, h, -1, -1), dS_out) * tail[..., None]
    dW = _mm3(dyc, xdt.transpose(-1, -2))                          # t x s
    Sc = _mm3(Cc, Bc.transpose(-1, -2))                            # t x s
    dect, dtl = (Cc * Q).sum(-1), (Bc * U).sum(-1)
    dC, dB = Q * ec[..., None], U * tail[..., None]
    incl = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    decay, w_in = clampexp(cum[..., :, None] - cum[..., None, :], -E, E)
    Ds = torch.where(incl, dW * decay, torch.zeros(()))
    Ws = torch.where(incl, Sc * decay, torch.zeros(()))
    z = torch.where(torch.tril(incl, -1) & w_in, Ds * Sc, torch.zeros(()))
    dcr, dcc = z.sum(-1), z.sum(-2)
    dC = dC + _mm3(Ds, Bc)
    dxa = dxa + _mm3(Ws.transpose(-1, -2), dyc)
    dB = dB + _mm3(Ds.transpose(-1, -2), Cc)
    ddt_x = (xc * dxa).sum(-1)
    dx = dxa * dtc[..., None] + D[:, None, None] * dyc
    # ddec: rows, then a 32-lane tree; dD's chunk sum the same way
    ddec = _warp_sum(_lanes64(_row_sums4(dS_out * S_in)).reshape(
        b, nc, h, 2, 32).sum(-2))
    yx = _warp_sum(_lanes64(_row_sums4(dyc * xc)).reshape(
        b, nc, h, 2, 32).sum(-2))
    zt = torch.where(t_in, dtl * tail, torch.zeros(()))
    ze = torch.where(e_in, dect * ec, torch.zeros(()))
    dcum = (dcr + ze) + (-dcc - zt)
    ztp = _lanes64(zt)
    dL = torch.where(in_d, ddec * dec, torch.zeros(())) + _warp_sum(
        ztp[..., 0::2] + ztp[..., 1::2])
    dcum[..., -1] = dcum[..., -1] + dL
    run = _suffix(dcum)[..., :chunk]
    ddt = ddt_x + run * a[:, None]
    rdt = _lanes64(run * dtc)
    da = _warp_sum(rdt[..., 0::2] + rdt[..., 1::2])                # bch
    # dB and dC: each group's heads in order, then the groups in order
    def reduce_heads(t):                                           # bchtn
        out = None
        for h0 in range(0, h, g):
            grp = t[:, :, h0]
            for j in range(h0 + 1, min(h0 + g, h)):
                grp = grp + t[:, :, j]
            out = grp if out is None else out + grp
        return out.reshape(b, s, n)
    dA_log, dD = torch.zeros(h), torch.zeros(h)
    for bi in range(b):                  # the partials in (batch, chunk) order
        for c in range(nc):
            dA_log, dD = dA_log + da[bi, c], dD + yx[bi, c]
    back = (lambda t: t.permute(0, 1, 3, 2, *range(4, t.dim())).reshape(
        b, s, h, *t.shape[4:]))
    return (back(dx), back(ddt[..., None])[..., 0], dA_log * a,
            reduce_heads(dB), reduce_heads(dC), dD, dstate)


def _inputs(b, s, h, p, n, seed, state):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(f)
    A_log = (rng.standard_normal(h) * 0.3).astype(f)
    B = rng.standard_normal((b, s, n)).astype(f)
    C = rng.standard_normal((b, s, n)).astype(f)
    D = rng.standard_normal(h).astype(f)
    s0 = rng.standard_normal((b, h, n, p)).astype(f)
    dy = rng.standard_normal((b, s, h, p)).astype(f)
    dS = rng.standard_normal((b, h, n, p)).astype(f) if state else None
    return [torch.from_numpy(t) for t in (x, dt, A_log, B, C, D, s0, dy)], (
        None if dS is None else torch.from_numpy(dS))


@pytest.mark.parametrize("b,s,h,p,n,chunk,g,state", [
    (2, 32, 3, 8, 4, 16, 2, False),      # a partial group of 1 head
    (1, 64, 5, 12, 7, 32, 3, True),      # odd widths, groups 3 + 2
    (2, 128, 8, 16, 16, 64, 8, True),    # one full group, a 64-row chunk
], ids=lambda v: str(v))
def test_fused_pass_orders_match_the_plain_version(b, s, h, p, n, chunk, g,
                                                   state):
    args, dS = _inputs(b, s, h, p, n, seed=s + h + n, state=state)
    x, dt, A_log, B, C, D, s0, dy = args
    got = _fused_backward(x, dt, A_log, B, C, D, s0, dy, dS, chunk, g)
    want = ssd_chunk_backward_plain(x, dt, A_log, B, C, D, s0, dy, dS,
                                    chunk=chunk)
    names = ("dx", "ddt", "dA_log", "dB", "dC", "dD", "dstate")
    for name, gt, wt in zip(names, got, want):
        assert gt.shape == wt.shape, name
        assert torch.isfinite(gt).all(), name
        tol = TOL_REDUCED if name in ("dA_log", "dD") else TOL
        err = float((gt - wt).abs().max())
        assert err <= tol * float(wt.abs().max()), (name, err)
