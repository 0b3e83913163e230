"""The port's ``kernels`` package against the JAX package, on the CPU.

On the CPU the port's wrappers (``systolic_mac``, ``razor_matmul``,
``precision_island``) take their kernels' plain PyTorch versions (the CUDA
kernels themselves are held against those same plain versions on the GPU by
``chip_smoke.py``).  Here the plain versions are held against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode, on
the same numpy-made inputs.

Tolerances, systolic_mac (those of ``tests/kernels/test_kernels.py``): flags
are equal; clean cells agree within ``1e-5 * max|C|`` (the frameworks sum in
another order); corrupted cells within ``2.5 * 2^-8 * max|C|`` (a sum that
differs in its last bits can fall on the other side of one truncation step).

razor_matmul and precision_island against the oracle: integer-path cells
bit for bit (both take the exact int32 product and dequantize in one order),
flags equal, ``rel`` and f32 cells within rtol 1e-5.  Against the Pallas
kernels: the JAX tests' own tolerances, since the Pallas body multiplies the
integer values in f32 and its interpreter can break rounding ties the other
way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import tuning as jtuning
from repro.kernels.ops import voltage_scaled_matmul as j_voltage_scaled_matmul
from repro.kernels.precision_island import (
    precision_island as j_precision_island)
from repro.kernels.razor_matmul import razor_matmul as j_razor_matmul
from repro.kernels.systolic_mac import systolic_mac as j_systolic_mac
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tuning as ttuning
from repro_torch.kernels.ops import (precision_mm, razor_mm, systolic_matmul,
                                    voltage_scaled_matmul)
from repro_torch.kernels.precision_island import (precision_island,
                                                  precision_island_plain)
from repro_torch.kernels.razor_matmul import razor_matmul, razor_matmul_plain
from repro_torch.kernels.systolic_mac import systolic_mac, systolic_mac_plain

JDT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}


def _ab(m, k, n, dtype, seed=0):
    """The same operands for both stacks: numpy f32 draws, rounded to the
    working type on each side (bf16 rounding is RNE in both)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return ((jnp.asarray(a).astype(JDT[dtype]), jnp.asarray(b).astype(JDT[dtype])),
            (torch.from_numpy(a).to(TDT[dtype]), torch.from_numpy(b).to(TDT[dtype])))


def _assert_cells_close(c, c_ref, fail, bm, bn):
    scale = float(np.abs(c_ref).max())
    gm, gn = fail.shape
    for i in range(gm):
        for j in range(gn):
            cell = (slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn))
            tol = scale * (2 ** -8 * 2.5 if fail[i, j] else 1e-5)
            np.testing.assert_allclose(c[cell], c_ref[cell], atol=tol)


@pytest.mark.parametrize("m,k,n,block", [(256, 256, 256, 128),
                                         (128, 512, 384, 128),
                                         (256, 128, 128, 64)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_systolic_mac_matches_jax_ref_and_pallas(m, k, n, block, dtype):
    (ja, jb), (ta, tb) = _ab(m, k, n, dtype)
    gm, gn = m // block, n // block
    v_map = np.random.default_rng(1).uniform(0.6, 1.0, (gm, gn))
    v_safe = np.full((gm, gn), 0.8)
    c, flags, count = systolic_mac(ta, tb, torch.from_numpy(v_map),
                                   torch.from_numpy(v_safe), block_m=block,
                                   block_n=block, count_flags=True)
    assert c.dtype == torch.float32 and flags.dtype == torch.int32
    c_ref, f_ref = jref.systolic_mac(ja, jb, jnp.asarray(v_map),
                                     jnp.asarray(v_safe), block=block)
    c_pl, f_pl = j_systolic_mac(ja, jb, jnp.asarray(v_map),
                                jnp.asarray(v_safe), block_m=block,
                                block_n=block, block_k=min(block, k),
                                interpret=True)
    fail = np.asarray(f_ref, bool)
    assert 0 < fail.sum() < fail.size          # both kinds of cell present
    for other_c, other_f in ((c_ref, f_ref), (c_pl, f_pl)):
        np.testing.assert_array_equal(flags.numpy(), np.asarray(other_f))
        _assert_cells_close(c.numpy(), np.asarray(other_c), fail, block, block)
    assert int(count) == int(fail.sum())


@pytest.mark.parametrize("m,bm,bn", [(1, 1, 1), (3, 1, 2), (7, 7, 16),
                                     (6, 2, 8), (7, 1, 1)])
def test_systolic_mac_non_square_cells_and_ragged_m(m, bm, bn):
    """Cell edges independent per axis, and the serving path's odd M."""
    k, n = 40, 32
    (ja, jb), (ta, tb) = _ab(m, k, n, "f32", seed=m)
    gm, gn = m // bm, n // bn
    rng = np.random.default_rng(bm * 10 + bn)
    v_map = rng.uniform(0.6, 1.0, (gm, gn)).astype(np.float32)
    v_safe = np.full((gm, gn), 0.8, np.float32)
    c, flags = systolic_mac(ta, tb, torch.from_numpy(v_map),
                            torch.from_numpy(v_safe))
    # oracle: the JAX corruption model applied cell by cell to the product
    prod = np.asarray(ja @ jb)
    fail = v_map < v_safe
    expect = prod.copy()
    for i in range(gm):
        for j in range(gn):
            if fail[i, j]:
                cell = (slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn))
                expect[cell] = np.asarray(jref.corrupt_low_bits(prod[cell]))
    np.testing.assert_array_equal(flags.numpy(), fail.astype(np.int32))
    _assert_cells_close(c.numpy(), expect, fail, bm, bn)
    # the wrapper's explicit-block form and the ops alias agree with it
    c2, flags2 = systolic_matmul(ta, tb, torch.from_numpy(v_map),
                                 torch.from_numpy(v_safe), block_m=bm,
                                 block_n=bn)
    assert torch.equal(c, c2) and torch.equal(flags, flags2)


def test_systolic_mac_nominal_voltage_exact_and_strided_b():
    """Nominal rails: the plain product; a transposed view of ``b`` gives
    what its contiguous copy gives."""
    (ja, jb), (ta, tb) = _ab(128, 128, 128, "f32")
    v = torch.ones((1, 1))
    c, flags = systolic_mac(ta, tb, v, v * 0.8)
    np.testing.assert_allclose(c.numpy(), np.asarray(ja @ jb), rtol=1e-5,
                               atol=1e-5)
    assert int(flags[0, 0]) == 0
    bt = tb.T.contiguous()                    # storage (N, K); .T is a view
    c_view, _ = systolic_mac(ta, bt.T, v, v * 0.8)
    assert not bt.T.is_contiguous() and torch.equal(c_view, c)


@pytest.mark.parametrize("keep_bits", [0, 4, 8, 16, 23])
def test_corrupt_low_bits_bit_for_bit(keep_bits):
    rng = np.random.default_rng(keep_bits)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-20, 20, 4096),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-40], np.float32)])
    want = np.asarray(jref.corrupt_low_bits(jnp.asarray(x), keep_bits))
    got = tref.corrupt_low_bits(torch.from_numpy(x), keep_bits).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_quantize_sym_i8_matches_jax():
    x = np.random.default_rng(3).standard_normal((17, 33)).astype(np.float32)
    x[4] = 0.0                                  # all-zero row: scale floor
    jq, js = jref.quantize_sym_i8(jnp.asarray(x))
    tq, ts = tref.quantize_sym_i8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_tuning_tables_equal_jax():
    assert ttuning.BLOCK_TABLE == jtuning.BLOCK_TABLE
    assert ttuning.CHUNK_TABLE == jtuning.CHUNK_TABLE
    sizes = (1, 3, 7, 8, 12, 24, 40, 64, 96, 128, 200, 256, 384, 1000, 3072,
             8192, 200192)
    for m in sizes:
        assert ttuning.select_chunk(m) == jtuning.select_chunk(m)
        for n in sizes:
            assert ttuning.select_blocks(m, n) == jtuning.select_blocks(m, n)
            assert ttuning.select_blocks(m, n, 96) == \
                jtuning.select_blocks(m, n, 96)
            assert ttuning.select_square_block(m, n) == \
                jtuning.select_square_block(m, n)
    assert ttuning.select_blocks(64, 64, table={"m": (16,)}) == \
        jtuning.select_blocks(64, 64, table={"m": (16,)})
    with pytest.raises(ValueError):
        ttuning.assert_divides(48, 100, "block")
    ttuning.assert_divides(50, 100, "block")


def test_voltage_scaled_matmul_flow_matches_jax():
    (ja, jb), (ta, tb) = _ab(256, 256, 512, "bf16", seed=7)
    c, info = voltage_scaled_matmul(ta, tb, block=128, n_partitions=4,
                                    v_min=1.0, v_crash=0.7)
    jc, jinfo = j_voltage_scaled_matmul(ja, jb, block=128, n_partitions=4,
                                        v_min=1.0, v_crash=0.7,
                                        interpret=True)
    assert tuple(c.shape) == (256, 512)
    for key in ("v_static", "v_runtime", "flags_static", "flags_runtime"):
        np.testing.assert_array_equal(np.asarray(info[key]),
                                      np.asarray(jinfo[key]), err_msg=key)
    assert info["n_fired_static"] == jinfo["n_fired_static"]
    assert info["n_fired_runtime"] == jinfo["n_fired_runtime"]
    assert info["n_fired_static"] == int(info["flags_static"].sum())
    assert info["energy_ratio_vs_nominal"] == jinfo["energy_ratio_vs_nominal"]
    assert info["energy_ratio_vs_nominal"] < 1.0
    _assert_cells_close(c.numpy(), np.asarray(jc),
                        np.asarray(jinfo["flags_runtime"], bool), 128, 128)


@pytest.mark.parametrize("bad", ["dtype", "shape", "grid", "keep_bits",
                                 "mixed"])
def test_systolic_mac_wrapper_rejects(bad):
    a, b = torch.zeros(4, 8), torch.zeros(8, 6)
    v = torch.ones(2, 3)
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            systolic_mac(a.to(torch.float16), b.to(torch.float16), v, v)
        elif bad == "shape":
            systolic_mac(a, torch.zeros(7, 6), v, v)
        elif bad == "grid":
            systolic_mac(a, b, torch.ones(3, 3), torch.ones(3, 3))
        elif bad == "keep_bits":
            systolic_mac(a, b, v, v, keep_bits=24)
        else:
            systolic_mac(a, b.to(torch.bfloat16), v, v)


def test_plain_version_is_the_ref_oracle():
    (_, _), (ta, tb) = _ab(16, 8, 16, "f32")
    v_map = torch.tensor([[1.0, 0.5], [0.5, 1.0]])
    v_safe = torch.full((2, 2), 0.8)
    c1, f1 = systolic_mac_plain(ta, tb, v_map, v_safe, block_m=8, block_n=8)
    c2, f2 = tref.systolic_mac(ta, tb, v_map, v_safe, block=8)
    assert torch.equal(c1, c2) and torch.equal(f1, f2)


# ------------------------------------------------------------------ razor ----


def _cells(cell_map, bm, bn):
    return np.repeat(np.repeat(np.asarray(cell_map), bm, 0), bn, 1)


def _split_tol(rel):
    """A tol halfway across the widest gap between sorted cell errors: both
    kinds of cell, far from the edge."""
    r = np.sort(np.asarray(rel, np.float64).ravel())
    i = int(np.argmax(np.diff(r)))
    return float((r[i] + r[i + 1]) / 2)


def _assert_razor_equal_to_oracle(c, flags, rel, jc, jf, jrel, bm, bn):
    jf = np.asarray(jf)
    np.testing.assert_array_equal(flags.numpy(), jf)
    np.testing.assert_allclose(rel.numpy(), np.asarray(jrel), rtol=1e-5)
    main = _cells(jf == 0, bm, bn)
    c, jc = c.numpy(), np.asarray(jc)
    np.testing.assert_array_equal(c[main].view(np.int32),
                                  jc[main].view(np.int32))
    np.testing.assert_allclose(c[~main], jc[~main], rtol=1e-5,
                               atol=1e-6 * np.abs(jc).max())


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (128, 384, 256)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("tol", ["0.05", "split"])
def test_razor_plain_matches_jax_ref_and_pallas(m, k, n, dtype, tol):
    (ja, jb), (ta, tb) = _ab(m, k, n, dtype, seed=2)
    if tol == "split":
        tol = _split_tol(jref.razor_matmul(ja, jb, tol=1.0, block=128)[2])
    else:
        tol = float(tol)
    c, flags, rel = razor_matmul(ta, tb, tol=tol)
    assert c.dtype == torch.float32 and flags.dtype == torch.int32
    assert tuple(flags.shape) == (m // 128, n // 128)
    jc, jf, jrel = jref.razor_matmul(ja, jb, tol=tol, block=128)
    _assert_razor_equal_to_oracle(c, flags, rel, jc, jf, jrel, 128, 128)
    if tol != 0.05:
        assert 0 < int(flags.sum()) < flags.numel()
    # the Pallas kernel, at the JAX test's tolerances
    pc, pf, prel = j_razor_matmul(ja, jb, tol=tol, interpret=True)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(pf))
    np.testing.assert_allclose(rel.numpy(), np.asarray(prel), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(pc), rtol=3e-3,
                               atol=0.15)


def test_razor_plain_matches_the_ref_oracle_on_other_cells():
    (_, _), (ta, tb) = _ab(64, 96, 48, "f32", seed=5)
    c1, f1, r1 = razor_matmul_plain(ta, tb, tol=0.0, block_m=16, block_n=16)
    c2, f2, r2 = tref.razor_matmul(ta, tb, tol=0.0, block=16)
    assert torch.equal(c1, c2) and torch.equal(f1, f2) and torch.equal(r1, r2)
    # all fired at tol 0: the result is the shadow product
    assert int(f1.sum()) == f1.numel()
    assert torch.equal(c1, ta @ tb)


def test_razor_flags_fire_on_outliers():
    """One huge weight element wrecks its column's int8 scale: that cell
    flags and is corrected to the shadow (f32) value, in both packages."""
    (ja, jb), (ta, tb) = _ab(128, 256, 256, "f32", seed=3)
    jb = jb.at[0, 0].set(1000.0)
    tb[0, 0] = 1000.0
    _, _, rel_ref = jref.razor_matmul(ja, jb, tol=1.0, block=128)
    r0, r1 = float(rel_ref[0, 0]), float(rel_ref[0, 1])
    assert r0 > r1 * 1.2
    tol = 0.5 * (r0 + r1)
    c, flags, rel = razor_matmul(ta, tb, tol=tol)
    assert flags.tolist() == [[1, 0]]
    np.testing.assert_array_equal(c[:, :128].numpy(), (ta @ tb)[:, :128])
    jc, jf, jrel = jref.razor_matmul(ja, jb, tol=tol, block=128)
    _assert_razor_equal_to_oracle(c, flags, rel, jc, jf, jrel, 128, 128)
    pc, pf, _ = j_razor_matmul(ja, jb, tol=tol, interpret=True)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(pf))
    np.testing.assert_allclose(c[:, :128].numpy(), np.asarray(pc)[:, :128],
                               rtol=1e-5)


def test_razor_fused_count_matches_flag_sum():
    (ja, jb), (ta, tb) = _ab(256, 128, 256, "f32", seed=3)
    tb[0, 0] = 500.0                          # poison one cell's scale
    _, _, rel = razor_matmul(ta, tb, tol=1e-6)
    tol = float(np.sort(rel.numpy().ravel())[-2] * 0.99)
    c, flags, rel, count = razor_matmul(ta, tb, tol=tol, count_flags=True)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(flags.sum()) >= 1
    _, jflags, _, jcount = j_razor_matmul(ja, jb.at[0, 0].set(500.0),
                                          tol=tol, count_flags=True,
                                          interpret=True)
    assert int(jcount) == int(count)
    np.testing.assert_array_equal(np.asarray(jflags), flags.numpy())


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 128),
                                   (24, 40, 200)])
def test_razor_defaults_match_explicit_blocks(shape):
    m, k, n = shape
    (_, _), (ta, tb) = _ab(m, k, n, "f32", seed=1)
    bm, bn = ttuning.select_blocks(m, n)
    c_auto, f_auto, r_auto = razor_matmul(ta, tb)
    c_exp, f_exp, r_exp = razor_matmul(ta, tb, block_m=bm, block_n=bn)
    assert tuple(f_auto.shape) == (m // bm, n // bn)
    assert torch.equal(c_auto, c_exp) and torch.equal(f_auto, f_exp)
    assert torch.equal(r_auto, r_exp)
    c_mm, f_mm, r_mm = razor_mm(ta, tb)                    # ops alias
    assert torch.equal(c_mm, c_auto) and torch.equal(f_mm, f_auto)


# -------------------------------------------------------------- precision ----


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("tiers", [[[0, 1], [2, 0]], [[2, 2], [2, 2]],
                                   [[0, 0], [0, 0]], [[1, 1], [1, 2]]])
def test_precision_plain_matches_jax_ref_and_pallas(tiers, dtype):
    (ja, jb), (ta, tb) = _ab(256, 256, 256, dtype, seed=4)
    t = np.asarray(tiers)
    c = precision_island(ta, tb, torch.as_tensor(t, dtype=torch.int32))
    c_ref = np.asarray(jref.precision_island(ja, jb, jnp.asarray(t, jnp.int32),
                                             block=128))
    c = c.numpy()
    exact = _cells(t < 2, 128, 128)
    np.testing.assert_array_equal(c[exact].view(np.int32),
                                  c_ref[exact].view(np.int32))
    np.testing.assert_allclose(c[~exact], c_ref[~exact], rtol=1e-5,
                               atol=1e-6 * np.abs(c_ref).max())
    # the Pallas kernel, at the JAX test's tolerances
    c_pl = np.asarray(j_precision_island(ja, jb, jnp.asarray(t, jnp.int32),
                                         interpret=True))
    for i in range(2):
        for j in range(2):
            blk = (slice(i * 128, (i + 1) * 128), slice(j * 128, (j + 1) * 128))
            if t[i, j] == 2:
                np.testing.assert_allclose(c[blk], c_pl[blk], rtol=1e-4,
                                           atol=1e-4)
            else:
                num = np.linalg.norm(c[blk] - c_pl[blk])
                den = np.linalg.norm(c_pl[blk]) + 1e-9
                bound = 4e-2 if (t[i, j] == 0 and dtype == "bf16") else 2e-2
                assert num / den < bound, (i, j, num / den)


def test_precision_plain_is_the_tiled_oracle_on_other_cells():
    (_, _), (ta, tb) = _ab(96, 80, 64, "bf16", seed=6)
    tiers = torch.tensor([[0, 1], [2, 1], [1, 0]], dtype=torch.int32)
    c1 = precision_island_plain(ta, tb, tiers, block_m=32, block_n=32)
    c2 = precision_island(ta, tb, tiers)
    assert torch.equal(c1, c2)
    assert torch.equal(c1, tref.precision_island(ta, tb, tiers, block=32))
    for i in range(3):
        for j in range(2):
            at, bt = ta[i * 32:(i + 1) * 32], tb[:, j * 32:(j + 1) * 32]
            want = tref._tile_matmul_at_tier(at, bt, tiers[i, j])
            got = c1[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32]
            if int(tiers[i, j]) < 2:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_precision_tiers_order_error():
    """int4 tile error > int8 tile error > f32 tile error vs exact."""
    (_, _), (ta, tb) = _ab(128, 256, 128, "f32", seed=5)
    exact = (ta @ tb).numpy()
    errs = []
    for tier in (0, 1, 2):
        c = precision_mm(ta, tb, torch.full((1, 1), tier, dtype=torch.int32))
        errs.append(np.abs(c.numpy() - exact).max())
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 1e-4


def test_precision_island_blocks_default_from_tiers():
    (_, _), (ta, tb) = _ab(256, 128, 512, "bf16", seed=8)
    tiers = torch.tensor([[0, 1, 2, 0], [1, 2, 0, 1]], dtype=torch.int32)
    c = precision_island(ta, tb, tiers)                    # 128 x 128 cells
    assert tuple(c.shape) == (256, 512)
    assert torch.equal(c, precision_island(ta, tb, tiers, block_m=128,
                                           block_n=128))


@pytest.mark.parametrize("x", ["normal", "ties", "zero_row"])
def test_quantize_sym_i4_and_i8_match_jax(x):
    rng = np.random.default_rng(9)
    if x == "normal":
        v = rng.standard_normal((19, 37)).astype(np.float32)
    elif x == "ties":        # x / scale lands exactly on .5: half to even
        v = np.tile(np.array([7.0, 0.5, 1.5, 2.5, -3.5, -0.5, 6.5],
                             np.float32), (4, 1))
        v[1] *= 127 / 7
    else:
        v = rng.standard_normal((5, 16)).astype(np.float32)
        v[2] = 0.0
    for jq_fn, tq_fn in ((jref.quantize_sym_i8, tref.quantize_sym_i8),
                         (jref.quantize_sym_i4, tref.quantize_sym_i4)):
        jq, js = jq_fn(jnp.asarray(v))
        tq, ts = tq_fn(torch.from_numpy(v))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bad", ["dtype", "shape", "cells", "mixed",
                                 "tiers_float", "tiers_grid"])
def test_razor_and_precision_wrappers_reject(bad):
    a, b = torch.zeros(16, 8), torch.zeros(8, 24)
    t = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            razor_matmul(a.to(torch.float16), b.to(torch.float16))
        elif bad == "shape":
            precision_island(a, torch.zeros(7, 24), t)
        elif bad == "cells":
            razor_matmul(a, b, block_m=5, block_n=8)
        elif bad == "mixed":
            razor_matmul(a, b.to(torch.bfloat16))
        elif bad == "tiers_float":
            precision_island(a, b, t.to(torch.float32))
        else:
            precision_island(a, b, t, block_m=4)


@pytest.mark.parametrize("k", [1024, 3072])
def test_integer_product_exact_where_the_pallas_form_is_not(k):
    """The Pallas bodies multiply the quantized values in f32
    (``jnp.dot(qa, qb.T, preferred_element_type=f32)``), which rounds as it
    sums once partial sums pass 2^24 (K * 127^2 does at K = 1041); the
    oracle takes the int32 product and rounds once.  At K = 1024 the two
    agree; at K = 3072 (phi4-mini's d_model) they do not, and the port's
    plain version (and its kernel, bit-equal to it on the card) sides with
    the oracle.  Operands in [0.5, 1): every partial sum grows."""
    rng = np.random.default_rng(12)
    a = rng.uniform(0.5, 1.0, (128, k)).astype(np.float32)
    b = rng.uniform(0.5, 1.0, (k, 128)).astype(np.float32)
    qa, _ = jref.quantize_sym_i8(jnp.asarray(a))
    qb, _ = jref.quantize_sym_i8(jnp.asarray(b).T)
    exact = np.asarray(qa, np.int64) @ np.asarray(qb, np.int64).T
    pallas_form = np.asarray(jnp.dot(jnp.asarray(qa, jnp.float32),
                                     jnp.asarray(qb, jnp.float32).T,
                                     preferred_element_type=jnp.float32))
    once = exact.astype(np.float32)                 # one rounding, as int32
    differ = pallas_form != once
    if k == 1024:
        assert not differ.any()
    else:
        assert differ.mean() > 0.1 and exact.max() > 2 ** 24
    port = tref.int_matmul_f32(torch.from_numpy(np.array(qa)),
                               torch.from_numpy(np.array(qb)))
    np.testing.assert_array_equal(port.numpy(), once)
    # and the whole main path equals the oracle's bit for bit
    c, flags, _ = razor_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               tol=1.0)
    jc, jf, _ = jref.razor_matmul(jnp.asarray(a), jnp.asarray(b), tol=1.0,
                                  block=128)
    assert not flags.any() and not np.asarray(jf).any()
    np.testing.assert_array_equal(c.numpy().view(np.int32),
                                  np.asarray(jc).view(np.int32))
