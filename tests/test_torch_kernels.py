"""The port's ``kernels`` package against the JAX package, on the CPU.

On the CPU the port's ``systolic_mac`` wrapper takes its kernel's plain
PyTorch version (the CUDA kernel itself is held against that same plain
version on the GPU by ``chip_smoke.py``).  Here the plain version is held
against ``repro.kernels.ref.systolic_mac`` and against the Pallas kernel in
interpret mode, on the same numpy-made inputs.

Tolerances (those of ``tests/kernels/test_kernels.py``): flags are equal;
clean cells agree within ``1e-5 * max|C|`` (the frameworks sum in another
order); corrupted cells within ``2.5 * 2^-8 * max|C|`` (a sum that differs
in its last bits can fall on the other side of one truncation step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import tuning as jtuning
from repro.kernels.ops import voltage_scaled_matmul as j_voltage_scaled_matmul
from repro.kernels.systolic_mac import systolic_mac as j_systolic_mac
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tuning as ttuning
from repro_torch.kernels.ops import systolic_matmul, voltage_scaled_matmul
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
