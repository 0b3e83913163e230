"""The launch plans of the ABFT guard's two kernels
(``repro_torch.kernels.abft``: ``abft_checksums`` and ``abft_verdict``), and
their arithmetic, on the CPU.

Without a card: the plans' constants are read back from
``csrc/abft_checksums.cu`` and the plan covers the operand; a numpy
emulation of each kernel's summation order (lanes, strips, warp-rows,
blocks, the groups' tickets and the call's last block) is held to the plain
versions for bf16, f32 and f64 operands, row-major, transposed and strided,
at M 1, 4 and 33, within ``TOL_ABFT`` of the sums of magnitudes; and the
plain verdict is held to the reference's numpy ``_abft_verify``
(``src/repro/resilience/guard.py:144``) on ``chip_smoke.py``'s seeded
corruptions and a clean product.
"""

import importlib.util
import re

import numpy as np
import pytest
import torch

import repro.resilience as jres
from repro_torch.kernels import _build
from repro_torch.kernels import abft as abft_mod
from repro_torch.kernels.abft import (SIDE_NONE, SIDE_P, SIDE_Q, LaunchPlan,
                                      launch_plan)

SRC = (_build.CSRC_DIR / "abft_checksums.cu").read_text()
#: float64 sums of the same terms in another order, as a fraction of the
#: sums of magnitudes (chip_smoke.py's TOL_ABFT)
TOL_ABFT = 1e-12
TOL = 1e-6

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_for_abft", _build.CSRC_DIR.parents[2] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}


def _constexpr(name):
    hit = re.search(rf"constexpr int {name} = (\w+);", SRC)
    assert hit, name
    return int(hit.group(1))


def test_plan_constants_are_the_cuda_source():
    assert _constexpr("WARPS") == abft_mod.WARPS
    assert _constexpr("CHUNK") == abft_mod.CHUNK_ROWS
    assert _constexpr("MAXV") == abft_mod.MAXV
    assert _constexpr("V_COLS") == abft_mod.VERDICT_COLS
    assert _constexpr("V_THREADS") == abft_mod.VERDICT_THREADS
    assert _constexpr("QROWS") == abft_mod.MAX_ROWS
    assert _constexpr("V_CLUSTER") == abft_mod.VERDICT_CLUSTER
    assert _constexpr("V_CROWS") == abft_mod.VERDICT_CLUSTER_ROWS
    assert _constexpr("V_PART") == abft_mod.VERDICT_PART == 5
    assert "constexpr int THREADS = WARPS * 32;" in SRC
    assert "constexpr int V_BLOCK = V_THREADS * V_COLS;" in SRC
    assert "constexpr int V_WARPS = V_THREADS / 32;" in SRC
    assert ("const int width = 32 * vec;" in SRC
            and "const int n_cb = (C + width - 1) / width;" in SRC
            and "const int n_rb = (R + rows - 1) / rows;" in SRC)
    assert "rows % CHUNK != 0" in SRC and "rows > QROWS" in SRC


@pytest.mark.parametrize("n", [1, 64, 1024, 3072, 4096, 4097, 8192, 8193,
                               200064])
def test_verdict_plan_covers_the_product(n):
    """The verdict's blocks cover the product's columns, as many as the C
    launcher forms."""
    blocks = abft_mod.verdict_plan(n)
    block = abft_mod.VERDICT_THREADS * abft_mod.VERDICT_COLS
    assert (blocks - 1) * block < n <= blocks * block
    launcher = SRC[SRC.index('extern "C" int abft_verdict_launch'):]
    assert ("const int blocks = N > 0 ? (N + V_BLOCK - 1) / V_BLOCK : 0;"
            in launcher)
    assert "cfg.blockDim = dim3(V_THREADS);" in launcher


def test_each_kernel_has_one_launch_site_and_its_scratch_one_cache():
    """The wrapper launches each kernel from one place (``_launch`` for
    ``abft_checksums``, the tests' seam), on the operand's device, with a
    configuration's Args, workspace and a's partials built once in one
    cache; the verdict is a fresh tensor a call."""
    import inspect
    text = inspect.getsource(abft_mod)
    assert text.count("abft_checksums_launch(") == 1
    assert text.count("abft_verdict_launch(") == 1
    assert "abft_checksums_launch(" in inspect.getsource(abft_mod._launch)
    assert text.count("= _Args(") == 1
    assert "= _Args(" in inspect.getsource(abft_mod._config)
    wrapper = inspect.getsource(abft_mod.abft_checksums)
    switch = wrapper.index("with torch.cuda.device(b.device):")
    assert switch < wrapper.index("_abft_route(")
    assert switch < wrapper.index("_general_route(")
    verdict = inspect.getsource(abft_mod.abft_verdict)
    assert "verdict = torch.empty((7,)" in verdict


@pytest.mark.parametrize("pointer", ["x == nullptr", "g.tickets == nullptr",
                                     "out_m == nullptr", "part_m == nullptr",
                                     "P == nullptr", "Q == nullptr",
                                     "out_r == nullptr", "out_c == nullptr",
                                     "g.part_r == nullptr",
                                     "g.part_c == nullptr", "chk == nullptr",
                                     "ticket == nullptr",
                                     "verdict == nullptr",
                                     "part == nullptr"])
def test_the_launchers_refuse_a_missing_pointer(pointer):
    """A pointer a launch would write or read, when null, is refused
    (cudaErrorInvalidValue) before any launch."""
    body = SRC[SRC.index('extern "C" int abft_checksums_launch'):]
    first_launch = body.index("launch_dtype<")
    verdict = body.index('extern "C" int abft_verdict_launch')
    if pointer in ("chk == nullptr", "ticket == nullptr",
                   "verdict == nullptr", "part == nullptr"):
        body = body[verdict:]
        first_launch = body.index("cudaLaunchKernelEx(")
    refusal = body[:first_launch]
    assert pointer in refusal
    assert "return static_cast<int>(cudaErrorInvalidValue);" in refusal


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(3072, 3072), (3072, 1024), (3072, 8192),
                                   (8192, 3072), (200192, 3072), (5, 3),
                                   (1000, 333), (77, 1001), (1, 70000)])
def test_launch_plan_covers_the_operand_in_one_wave(shape, dtype):
    r, c = shape
    plan = launch_plan(r, c, DTYPES[dtype])
    assert plan.rows % abft_mod.CHUNK_ROWS == 0
    assert abft_mod.MIN_ROWS <= plan.rows <= abft_mod.MAX_ROWS
    assert plan.rows % abft_mod.WARPS == 0
    assert plan.strip * plan.elem == abft_mod.LANES * abft_mod.LANE_BYTES
    assert plan.n_cb * plan.strip >= c > (plan.n_cb - 1) * plan.strip
    assert plan.n_rb * plan.rows >= r > (plan.n_rb - 1) * plan.rows
    assert plan.n_rb <= 65535
    # one wave, unless the blocks hit the least or most rows, or C alone
    # asks more
    assert (plan.n_cb * plan.n_rb <= abft_mod.TARGET_BLOCKS
            or plan.rows in (abft_mod.MIN_ROWS, abft_mod.MAX_ROWS)
            or plan.n_cb > abft_mod.TARGET_BLOCKS)
    # fixed by the operand's shape and type
    assert launch_plan(r, c, DTYPES[dtype]) == plan


def test_launch_plan_at_phi4_minis_weights():
    """The blocks the guarded decode step runs (bf16; the logits weight a
    transposed view, X = W (200192, 3072))."""
    got = {(r, c): (p.rows, p.n_cb, p.n_rb)
           for r, c in ((3072, 3072), (3072, 1024), (3072, 8192),
                        (8192, 3072), (200192, 3072))
           for p in [launch_plan(r, c, torch.bfloat16)]}
    assert got == {(3072, 3072): (160, 12, 20),
                   (3072, 1024): (64, 4, 48),
                   (3072, 8192): (384, 32, 8),
                   (8192, 3072): (384, 12, 22),
                   (200192, 3072): (1024, 12, 196)}
    for (r, c), (rows, n_cb, n_rb) in got.items():
        assert (n_cb * n_rb <= abft_mod.TARGET_BLOCKS
                or rows == abft_mod.MAX_ROWS)


# ---- a numpy emulation of the kernels' summation order ----------------------


def _seq(terms):
    """Terms added one after the other from 0.0 (a loop in the kernel)."""
    s = np.zeros_like(terms[0]) if len(terms) else 0.0
    for t in terms:
        s = s + t
    return s


def _widen(x):
    return x.to(torch.float64).numpy()


def _tree(terms):
    """Terms added as a tree of halves (the kernel's tree8 for 8)."""
    if len(terms) == 1:
        return terms[0]
    h = len(terms) // 2
    return _tree(terms[:h]) + _tree(terms[h:])


def _lanes(terms):
    """32 lane values added as the kernel's slot_sum adds them: each 8
    lanes as a tree, then the 4 sums as a tree."""
    return _tree([_tree(terms[8 * q:8 * q + 8]) for q in range(4)])


def _lane_products(xs, ps):
    """A lane's products over its columns as the kernel's lane_sum adds
    them: pairs (``x_1 p_1 + x_0 p_0``), then the pairs as a tree."""
    return _tree([xs[2 * i + 1] * ps[2 * i + 1] + xs[2 * i] * ps[2 * i]
                  for i in range(len(xs) // 2)])


def _lane_split(terms):
    """Values added by a warp, a lane every 32nd in order, lanes as
    :func:`_lanes`."""
    zero = np.zeros_like(terms[0])
    return _lanes([_seq(terms[lane::32]) if lane < len(terms) else zero
                   for lane in range(32)])


def emulate_checksums(plan, x64, p, pabs, q, qabs, a64=None, a_side=SIDE_NONE,
                      tol=0.0):
    """csrc/abft_checksums.cu on X (R, C), in float64 numpy, term by term in
    its order: ``(Yr (R, np), Yc (nq, C), out_m (2, M) or None)`` before
    the ``(y + 1) * tol`` of the outputs that take it.  In the abft mode the
    b-side (ones') sums are None, as the kernel writes none."""
    r_tot, c_tot = x64.shape
    if a_side != SIDE_NONE:
        asum = _seq(list(a64))                         # over m, in order
        aabs = _seq(list(np.abs(a64)))
        if a_side == SIDE_P:
            p, q = np.stack([asum, aabs], axis=1), np.ones((2, r_tot))
        else:
            p, q = np.ones((c_tot, 2)), np.stack([asum, aabs])
    n_p, n_q = p.shape[1], q.shape[0]
    ax = np.abs(x64)
    vec, rows, warps = plan.vec, plan.rows, abft_mod.WARPS
    # a block's sums along C: a lane's columns (pairs, then a tree), the 32
    # lanes; blk_r[cb][j] (R,)
    blk_r = []
    for cb in range(plan.n_cb):
        per_j = []
        for j in range(n_p):
            xj = ax if (pabs >> j) & 1 else x64
            lanes = []
            for lane in range(32):
                cols = range(cb * plan.strip + lane * vec,
                             cb * plan.strip + (lane + 1) * vec)
                lanes.append(_lane_products(
                    [xj[:, c] if c < c_tot else np.zeros(r_tot)
                     for c in cols],
                    [p[c, j] if c < c_tot else 0.0 for c in cols]))
            per_j.append(_lanes(lanes))
        blk_r.append(per_j)
    # a block's sums along R: a thread's rows (every 8th) in order, the
    # warps in order; blk_c[rb][i] (C,)
    blk_c = []
    for rb in range(plan.n_rb):
        r0 = rb * rows
        per_i = []
        for i in range(n_q):
            xi = ax if (qabs >> i) & 1 else x64
            per_w = []
            for w in range(warps):
                rs = [r for r in range(r0 + w, r0 + rows, warps) if r < r_tot]
                per_w.append(_seq([q[i, r] * xi[r] for r in rs])
                             if rs else np.zeros(c_tot))
            per_i.append(_seq(per_w))
        blk_c.append(per_i)
    # across blocks, in block order (one block: its sums)
    yr = np.zeros((r_tot, n_p))
    for j in range(n_p):
        yr[:, j] = blk_r[0][j] if plan.n_cb == 1 else _seq(
            [blk_r[cb][j] for cb in range(plan.n_cb)])
    yc = np.zeros((n_q, c_tot))
    for i in range(n_q):
        yc[i] = blk_c[0][i] if plan.n_rb == 1 else _seq(
            [blk_c[rb][i] for rb in range(plan.n_rb)])
    if a_side == SIDE_NONE:
        return yr, yc, None
    # the products with a: each block's b-side sums times a over its rows
    # (on Q) or columns (on P), a lane every 32nd k; then the blocks in
    # block order (rb-major), a lane every 32nd block
    coef = (a64, np.abs(a64))
    parts = []
    for rb in range(plan.n_rb):
        for cb in range(plan.n_cb):
            if a_side == SIDE_Q:
                k0, k1 = rb * rows, min((rb + 1) * rows, r_tot)
                bside = [blk_r[cb][j][k0:k1] for j in range(2)]
            else:
                k0, k1 = cb * plan.strip, min((cb + 1) * plan.strip, c_tot)
                bside = [blk_c[rb][j][k0:k1] for j in range(2)]
            parts.append([_lane_split([coef[j][:, k0 + t] * bside[j][t]
                                       for t in range(k1 - k0)])
                          for j in range(2)])
    out_m = np.stack([_lane_split([part[j] for part in parts])
                      for j in range(2)])
    if a_side == SIDE_Q:
        return None, yc, out_m
    return yr, None, out_m


def _affine(y, aff, tol):
    y = y.copy()
    for j in range(y.shape[1]):
        if (aff >> j) & 1:
            y[:, j] = (y[:, j] + 1.0) * tol
    return y


def emulated_launch(x, p, pabs, q, qabs, out_r, aff_r, out_c, aff_c, a=None,
                    a_side=SIDE_NONE, tol=0.0, out_m=None):
    """kernels/abft.py's ``_launch`` with the kernel emulated: the same
    arguments, the same writes into the output views."""
    plan = launch_plan(*x.shape, x.dtype)
    yr, yc, ym = emulate_checksums(
        plan, _widen(x), None if p is None else p.numpy(), pabs,
        None if q is None else q.numpy(), qabs,
        None if a is None else _widen(a), a_side, tol)
    if out_r is not None:
        out_r.copy_(torch.as_tensor(_affine(yr, aff_r, tol)))
    if out_c is not None:
        out_c.copy_(torch.as_tensor(_affine(yc.T, aff_c, tol).T))
    if a_side == SIDE_Q:
        assert out_r is None and yr is None     # the b-side is not written
    if a_side == SIDE_P:
        assert out_c is None and yc is None
    if out_m is not None:
        ym[1] = (ym[1] + 1.0) * tol
        out_m.copy_(torch.as_tensor(ym))
    abft_mod.abft_checksums.launches += 1


def _operand(rng, k, n, dtype, layout):
    if layout == "row-major":
        b = torch.as_tensor(rng.normal(size=(k, n)))
    elif layout == "transposed":
        b = torch.as_tensor(rng.normal(size=(n, k))).T
    else:                                   # every other column of a table
        b = torch.as_tensor(rng.normal(size=(k, 2 * n)))[:, ::2]
    return b.to(dtype)


def _pack_scale(a, b):
    """The sums of magnitudes each entry of the pack is a sum of."""
    a64, b64 = np.abs(_widen(a)), np.abs(_widen(b))
    mags = np.concatenate([a64 @ b64.sum(axis=1), a64.sum(axis=0) @ b64])
    return np.stack([mags, (mags + 1.0) * TOL])


@pytest.mark.parametrize("m", [1, 4, 33])
@pytest.mark.parametrize("layout", ["row-major", "transposed", "strided"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_emulated_checksums_order_within_tol_of_the_plain_version(
        dtype, layout, m, monkeypatch):
    """The abft mode through the wrapper's own route (which axis is X's,
    where a's sums and the outputs go), each launch emulated in the kernel's
    order: the pack within TOL_ABFT of the plain version's."""
    monkeypatch.setattr(abft_mod, "_launch", emulated_launch)
    monkeypatch.setattr(abft_mod.abft_checksums, "launches", 0)
    rng = np.random.default_rng(20 + m)
    k, n = 300, 700
    b = _operand(rng, k, n, DTYPES[dtype], layout)
    a = torch.as_tensor(rng.normal(size=(m, k))).to(DTYPES[dtype])
    got = abft_mod._abft_route(b, a, TOL).numpy()
    want = abft_mod.abft_checksums_plain(b, a=a, tol=TOL).numpy()
    assert got.shape == want.shape == (2, m + n)
    assert np.all(np.abs(got - want) <= TOL_ABFT * _pack_scale(a, b))
    assert abft_mod.abft_checksums.launches == 1


@pytest.mark.parametrize("rows", [32, 96, 1024])
@pytest.mark.parametrize("a_side", [SIDE_Q, SIDE_P])
def test_emulated_order_with_many_groups(rows, a_side):
    """Plans the small shapes above do not reach (many row and column
    groups, a block past R), both sides of a's sums: the emulation within
    TOL_ABFT of float64 numpy."""
    rng = np.random.default_rng(rows)
    r, c, m = 1000, 1536, 4
    x = torch.as_tensor(rng.normal(size=(r, c))).to(torch.bfloat16)
    x64 = _widen(x)
    kdim = r if a_side == SIDE_Q else c
    a64 = _widen(torch.as_tensor(rng.normal(size=(m, kdim))).to(
        torch.bfloat16))
    plan = LaunchPlan(r, c, 2, rows)
    yr, yc, ym = emulate_checksums(plan, x64, None, 0b10, None, 0b10, a64,
                                   a_side, TOL)
    asum, aabs = a64.sum(axis=0), np.abs(a64).sum(axis=0)
    ax = np.abs(x64)
    if a_side == SIDE_Q:
        got, want = yc, np.stack([asum @ x64, aabs @ ax])
        scale = np.abs(want[1:2]) + ax.sum(axis=0, keepdims=True)
        want_m = np.stack([a64 @ x64.sum(axis=1),
                           np.abs(a64) @ ax.sum(axis=1)])
        scale_m = np.abs(a64) @ ax.sum(axis=1)
    else:
        got, want = yr, np.stack([x64 @ asum, ax @ aabs], axis=1)
        scale = np.abs(want[:, 1:2]) + ax.sum(axis=1, keepdims=True)
        want_m = np.stack([a64 @ x64.sum(axis=0),
                           np.abs(a64) @ ax.sum(axis=0)])
        scale_m = np.abs(a64) @ ax.sum(axis=0)
    assert np.all(np.abs(got - want) <= TOL_ABFT * scale)
    assert np.all(np.abs(ym - want_m) <= TOL_ABFT * scale_m)
    # the general form on the same plan (both sides' sums written)
    p = np.stack([np.ones(c), rng.normal(size=c)], axis=1)
    q = np.stack([rng.normal(size=r), np.ones(r)])
    yr, yc, _ = emulate_checksums(plan, x64, p, 0b10, q, 0b10)
    want_r = np.stack([x64 @ p[:, 0], ax @ p[:, 1]], axis=1)
    want_c = np.stack([q[0] @ x64, q[1] @ ax])
    assert np.all(np.abs(yr - want_r) <= TOL_ABFT * (ax @ np.abs(p)))
    assert np.all(np.abs(yc - want_c) <= TOL_ABFT * (np.abs(q) @ ax))


@pytest.mark.parametrize("layout", ["row-major", "transposed"])
@pytest.mark.parametrize("n_probe", [0, 2, 5])
def test_emulated_general_form_within_tol_of_the_plain_version(
        layout, n_probe, monkeypatch):
    """The general form (Freivalds' probes, u with |b| rows) through the
    wrapper's route, each launch emulated."""
    monkeypatch.setattr(abft_mod, "_launch", emulated_launch)
    monkeypatch.setattr(abft_mod.abft_checksums, "launches", 0)
    rng = np.random.default_rng(7 + n_probe)
    k, n = 260, 520
    b = _operand(rng, k, n, torch.float32, layout)
    v = torch.as_tensor(rng.integers(0, 2, size=(n, n_probe)) * 2.0 - 1.0)
    u = torch.as_tensor(rng.normal(size=(1, k)))
    u = torch.cat([u, u.abs()])
    got = abft_mod._general_route(b, v, u, 1)
    want = abft_mod.abft_checksums_plain(b, v, u, 1)
    babs = _widen(b.abs())
    scales = (babs.sum(axis=1, keepdims=True), u.abs().numpy() @ babs)
    for g, w, s in zip(got, want, scales):
        assert g.shape == w.shape
        assert np.all(np.abs(g.numpy() - w.numpy()) <= TOL_ABFT * s)
    assert abft_mod.abft_checksums.launches == max(1, -(-n_probe // 3))


def _shuffle_tree(vals):
    """32 lane values added as ``__shfl_down_sync`` halving steps add them
    into lane 0."""
    vals = list(vals)
    for off in (16, 8, 4, 2, 1):
        for lane in range(off):
            vals[lane] = vals[lane] + vals[lane + off]
    return vals[0]


def emulate_verdict(out, checks):
    """csrc/abft_checksums.cu's abft_verdict in float64 numpy: column sums
    down the rows in order; a row's sum over a block's 4096 columns (a
    thread's 8 in order, a shuffle tree over a warp's 32 lanes, the 16 warps
    in order), then over the blocks in order; the verdict from those as the
    plain version forms it."""
    o = _widen(out)
    m, n = o.shape
    chk = checks.numpy()
    cs = _seq(list(o))
    threads, cols = abft_mod.VERDICT_THREADS, abft_mod.VERDICT_COLS
    parts = []
    for vb in range(abft_mod.verdict_plan(n)):
        c0 = vb * threads * cols
        per_thread = []
        for t in range(threads):
            cc = [c0 + t + threads * v for v in range(cols)]
            per_thread.append(_seq([o[:, c] if c < n else np.zeros(m)
                                    for c in cc]))
        warps = [_shuffle_tree(per_thread[32 * w:32 * w + 32])
                 for w in range(threads // 32)]
        parts.append(_seq(warps))
    rs = _seq(parts)
    err = np.concatenate([rs, cs]) - chk[0]
    ratio = np.abs(err) / chk[1]
    bad = ratio > 1.0
    rows, cols_bad = np.flatnonzero(bad[:m]), np.flatnonzero(bad[m:])
    i = rows[0] if rows.size else 0
    j = cols_bad[0] if cols_bad.size else 0
    return np.array([rows.size, cols_bad.size, i, j, err[i], err[m + j],
                     ratio.max()])


def _corrupted(rng, m, k, n, dtype, hits):
    """chip_smoke.py's abft_verdicts: a clean product in float64 with the
    seeded hits added, as a fraction of max|C|."""
    a = torch.as_tensor(rng.normal(size=(m, k))).to(dtype)
    b = torch.as_tensor(rng.normal(size=(k, n)) / np.sqrt(k)).to(dtype)
    clean = a.to(torch.float64) @ b.to(torch.float64)
    prod = clean.clone()
    scale = float(clean.abs().max())
    for i, j, f in hits:
        prod[i, j] += f * scale
    return a, b, prod


CASES = (("clean", []),) + tuple(chip_smoke.CORRUPTIONS)


@pytest.mark.parametrize("n", [2100, 6000])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_emulated_verdict_equals_the_plain_version(case, dtype, n):
    """The verdict kernel's order on a product of each type, one block or
    two: counts and first indices equal, residuals within TOL_ABFT of the
    magnitude sums."""
    hits = dict(CASES)[case]
    rng = np.random.default_rng(5)
    a, b, prod = _corrupted(rng, 4, 96, n, torch.float64, hits)
    out = prod.to(DTYPES[dtype])
    checks = abft_mod.abft_checksums_plain(b, a=a, tol=TOL)
    got = emulate_verdict(out, checks)
    want = abft_mod.abft_verdict_plain(out, checks).numpy()
    assert list(got[:4]) == list(want[:4])
    mag = float(np.abs(_widen(out)).sum()) + float(checks[0].abs().max())
    assert np.all(np.abs(got[4:6] - want[4:6]) <= TOL_ABFT * mag)
    assert abs(got[6] - want[6]) <= 1e-9 * max(1.0, want[6])
    if hits or dtype == "f64":                 # a seeded hit is seen
        assert (got[0] + got[1] > 0) == bool(hits)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_plain_verdict_equals_the_references_numpy(case):
    """abft_verdict_plain against repro.resilience.guard's _abft_verify on
    the same operands and product: bad-row and bad-column counts, the first
    of each, their residuals."""
    hits = dict(CASES)[case]
    rng = np.random.default_rng(11)
    a, b, prod = _corrupted(rng, 4, 200, 96, torch.float32, hits)
    jguard = jres.GuardedBackend("ideal", tol=TOL)
    ref = jguard._abft_verify(_widen(a), _widen(b), prod.numpy())
    checks = abft_mod.abft_checksums(b, a=a, tol=TOL)
    got = abft_mod.abft_verdict(prod, checks).tolist()
    assert got[0] == ref.bad_rows.size and got[1] == ref.bad_cols.size
    assert ref.ok == (got[0] == 0 and got[1] == 0) == (not hits)
    i = int(ref.bad_rows[0]) if ref.bad_rows.size else 0
    j = int(ref.bad_cols[0]) if ref.bad_cols.size else 0
    assert (got[2], got[3]) == (i, j)
    mag = float(prod.abs().sum())
    assert abs(got[4] - ref.row_err[i]) <= TOL_ABFT * mag
    assert abs(got[5] - ref.col_err[j]) <= TOL_ABFT * mag
    assert abft_mod.abft_verdict.launches == 0        # the CPU took no kernel
