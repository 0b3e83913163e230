"""The port's ``backend`` package against ``repro.backend``, on the CPU.

Bit-identity across the two packages is only meaningful when the result does
not depend on the order of summation, so — as ``tests/backend/test_parity.py``
does — the matrix uses small integer-valued operands: every partial product
and sum is exact in f32, and the exact product is the one answer both
packages must hit bit for bit.  The int8 tier also exercises both shared
quantizers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backend as jbackend
from repro_torch import backend as tbackend
from repro_torch.backend import impls as timpls
from repro_torch.backend.base import largest_common_block

BACKENDS = ("ideal", "reference")
PRECISIONS = (None, "f32", "int8")
#: the three shapes of tests/backend/test_parity.py
SHAPES = ((8, 8, 8), (16, 24, 8), (12, 40, 20))


def _int_valued(rng, shape):
    return rng.integers(-4, 5, size=shape).astype(np.float32)


@pytest.mark.parametrize("precision", PRECISIONS, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", BACKENDS)
def test_parity_across_packages(name, shape, precision):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, b = _int_valued(rng, (m, k)), _int_valued(rng, (k, n))
    j_out, j_tel = jbackend.get_backend(name).matmul(a, b,
                                                     precision=precision)
    t_be = tbackend.get_backend(name, device="cpu")
    t_out, t_tel = t_be.matmul(a, b, precision=precision)
    assert t_out.dtype == torch.float32 and tuple(t_out.shape) == (m, n)
    assert np.array_equal(t_out.numpy(), np.asarray(j_out))
    assert np.array_equal(t_out.numpy(), (a.astype(np.float64)
                                          @ b.astype(np.float64))
                          .astype(np.float32)) or precision == "int8"
    assert t_tel.to_dict() == j_tel.to_dict()
    assert t_tel.calls == 1 and t_tel.macs == m * k * n and t_tel.flags == 0
    assert t_be.summary() == {"backend": name, **j_tel.to_dict()}


def test_int8_path_on_real_valued_inputs_matches_jax():
    """The shared quantizers agree bit for bit off the integer grid too
    (the product of two int8 matrices with K = 24 is exact in f32)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal((24, 8)).astype(np.float32)
    jq, js = jbackend.quantize_sym_i8(a)
    tq, ts = tbackend.quantize_sym_i8(torch.from_numpy(a))
    assert np.array_equal(tq.numpy(), jq) and np.array_equal(ts.numpy(), js)
    for name in BACKENDS:
        j_out, _ = jbackend.get_backend(name).matmul(a, b, precision="int8")
        t_out, _ = tbackend.get_backend(name, device="cpu").matmul(
            a, b, precision="int8")
        assert np.array_equal(t_out.numpy(), np.asarray(j_out)), name


def test_native_precision_keeps_bf16_and_rounds_once():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_int_valued(rng, (4, 16))).to(torch.bfloat16)
    b = torch.from_numpy(_int_valued(rng, (16, 8))).to(torch.bfloat16)
    outs = {n: tbackend.get_backend(n, device="cpu").matmul(a, b)[0]
            for n in BACKENDS}
    assert all(o.dtype == torch.bfloat16 for o in outs.values())
    assert torch.equal(outs["ideal"], outs["reference"])
    f32, _ = tbackend.get_backend("reference", device="cpu").matmul(
        a, b, precision="f32")
    assert f32.dtype == torch.float32


def test_registry_and_scoping():
    # importing repro_torch.resilience registers "guarded", as importing
    # repro.resilience does in the JAX package
    import repro_torch.resilience  # noqa: F401
    assert tbackend.available_backends() == ["emulated", "guarded", "ideal",
                                             "reference", "simulated"]
    with pytest.raises(KeyError, match="unknown backend 'nope'"):
        tbackend.get_backend("nope")
    for name in ("emulated", "simulated"):
        assert tbackend.get_backend(name, device="cpu").name == name
    be = tbackend.get_backend("reference", device="cpu")
    assert tbackend.get_backend(be) is be
    with pytest.raises(ValueError):
        tbackend.get_backend(be, device="cpu")
    assert tbackend.ensure_host_callback_capacity() is False

    a = torch.ones(2, 3, 4)
    b = torch.ones(4, 5)
    with tbackend.use_backend(be) as scoped:
        assert scoped is be and tbackend.current_backend() is be
        out = tbackend.matmul(a, b)                 # (..., K) flattened
        with tbackend.use_backend("ideal", device="cpu") as inner:
            assert tbackend.current_backend() is inner
            tbackend.matmul(a, b)
        assert tbackend.current_backend() is be
    assert tuple(out.shape) == (2, 3, 5) and bool((out == 4).all())
    assert be.total.calls == 1 and be.total.macs == 6 * 4 * 5
    prev = tbackend.set_default("reference", device="cpu")
    try:
        assert tbackend.current_backend() is prev
        tbackend.matmul(a, b)
        assert prev.total.calls == 1
    finally:
        tbackend.set_default("ideal", device="cpu")


def test_bad_operands_raise():
    be = tbackend.get_backend("reference", device="cpu")
    with pytest.raises(ValueError):
        be.matmul(np.zeros((2, 3), np.float32), np.zeros((4, 5), np.float32))
    with pytest.raises(ValueError):
        be.matmul(np.zeros((2, 3), np.float32), np.zeros((3, 5), np.float32),
                  precision="fp4")


class _Undervolted(timpls.ReferenceBackend):
    """Reference backend with every rail under the safe voltage."""

    def _nominal(self, grid, device):
        return (torch.zeros(grid, device=device),
                torch.ones(grid, device=device))


def test_flags_counted_and_count_flags_false():
    a = np.random.default_rng(2).standard_normal((8, 8)).astype(np.float32)
    be = _Undervolted(device="cpu")
    out, tel = be.matmul(a, a)
    block = largest_common_block(8, 8)
    assert tel.flags == (8 // block) ** 2 > 0
    # every cell corrupted: low 15 mantissa bits gone
    assert np.array_equal(out.numpy().view(np.uint32) & 0x7FFF,
                          np.zeros((8, 8), np.uint32))
    _, tel2 = be.matmul(a, a, count_flags=False)
    assert tel2.flags == 0 and tel2.partition_flags is None
    assert tel2.calls == 1 and tel2.macs == 512      # the work still counted
    popped = be.pop_telemetry()
    assert popped.calls == 2 and popped.flags == tel.flags
    assert be.pop_telemetry().calls == 0
    assert be.summary()["flags"] == tel.flags and be.summary()["calls"] == 2


class _Deferring(_Undervolted):
    """Adds a count of its own into the router's counter with one tensor
    addition, as a backend whose kernel returns a fresh count would."""

    def _execute(self, a, b, count_flags, counter):
        own = torch.zeros((), dtype=torch.int32) if count_flags else None
        c, tel = super()._execute(a, b, count_flags, own)
        if count_flags:
            counter += own
        return c, tel


class _HostCounted(_Undervolted):
    """Knows its flag count on the host: reports it in the telemetry and
    leaves the router's counter alone."""

    def _execute(self, a, b, count_flags, counter):
        own = torch.zeros((), dtype=torch.int32) if count_flags else None
        c, tel = super()._execute(a, b, count_flags, own)
        if count_flags:
            tel.flags = int(own)
        return c, tel


@pytest.mark.parametrize("cls", [_Undervolted, _Deferring, _HostCounted])
def test_routed_matmul_accumulates_flags_for_pop(cls):
    """Model GEMMs defer their flag counts; pop_telemetry / summary settle
    them: (2, 4) has two 2x2 cells, (2, 2) one."""
    be = cls(device="cpu")
    x = torch.ones(2, 8)
    with tbackend.use_backend(be):
        tbackend.matmul(x, torch.ones(8, 4))
        tbackend.matmul(x, torch.ones(8, 2))
    tel = be.pop_telemetry()
    assert tel.calls == 2 and tel.flags == 3
    assert be.pop_telemetry().flags == 0
    with tbackend.use_backend(be):
        tbackend.matmul(x, torch.ones(8, 2))
    assert be.summary()["flags"] == 4
    _, direct = be.matmul(x, torch.ones(8, 4))
    assert direct.flags == 2 and be.summary()["flags"] == 6


def test_straight_through_gradient_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((6, 10)).astype(np.float32)
    b = rng.standard_normal((10, 4)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)

    jbe = jbackend.get_backend("reference")
    ja, jb = jax.grad(lambda x, y: jnp.sum(jbe.traced_matmul(x, y) * w),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))

    for be in (tbackend.get_backend("reference", device="cpu"),
               _Undervolted(device="cpu")):
        ta = torch.from_numpy(a).requires_grad_()
        tb = torch.from_numpy(b).requires_grad_()
        with tbackend.use_backend(be):
            loss = (tbackend.matmul(ta, tb) * torch.from_numpy(w)).sum()
        loss.backward()
        # exact products of the same f32 operands; summation order differs
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb),
                                   rtol=1e-5, atol=1e-5)
        assert be.total.calls == 1


def test_attach_obs_times_every_gemm():
    from repro_torch.obs import ObsBus
    ticks = iter(range(100))
    bus = ObsBus(clock=lambda: float(next(ticks)))
    be = tbackend.get_backend("reference", device="cpu")
    be.attach_obs(bus)
    be.matmul(np.ones((2, 2), np.float32), np.ones((2, 2), np.float32))
    text = bus.registry.render_prometheus()
    assert 'backend_callback_seconds_count{backend="reference"} 1' in text
