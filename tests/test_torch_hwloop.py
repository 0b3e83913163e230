"""The port's ``hwloop``, ``runtime`` and simulated/emulated backends against
``repro.hwloop``, ``repro.runtime`` and ``repro.backend``, on the CPU.

On CPU operands the port runs the reference's tile loops in numpy, so every
scenario here feeds both packages the same numpy-made inputs and holds the
port to the reference bit for bit: products, flags, counts, rails, ledger
totals and ``rel_error``, on integer-valued and on real-valued operands.
The backend parity matrix of ``tests/backend/test_parity.py`` uses
integer-valued operands, whose exact product is the one answer every
backend of both packages must hit.  The tiled form the port runs on a GPU is
held against the loop in ``tests/test_torch_hwloop_tiles.py``.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import repro.flow as jflow
import repro.hwloop as jhw
import repro.runtime as jrt
import repro_torch.flow as tflow
import repro_torch.hwloop as thw
import repro_torch.runtime as trt
from repro import backend as jbackend
from repro.hwloop import inject as jinject
from repro_torch import backend as tbackend
from repro_torch.hwloop import inject as tinject
from test_torch_core import assert_same

CFG_KW = dict(array_n=8, tech="vtr-22nm", max_trials=8, seed=2021)
BACKENDS = ("ideal", "reference", "simulated", "emulated")
SHAPES = ((8, 8, 8), (16, 24, 8), (12, 40, 20))
#: deep in the vtr-22nm crash region: every partition corrupts silently
V_CRASH = 0.58


@pytest.fixture(scope="module")
def reports():
    return (jflow.run(jflow.FlowConfig(**CFG_KW)),
            tflow.run(tflow.FlowConfig(**CFG_KW)))


def _int_valued(rng, shape):
    return rng.integers(-4, 5, size=shape).astype(np.float32)


def _same_tel(t, j):
    assert_same(t.to_dict(), j.to_dict(), "telemetry")


def _same_mtel(t, j):
    """MatmulTelemetry of the two packages, field for field."""
    for f in ("detected_p", "silent_p", "macs_p", "partition_flags"):
        assert_same(getattr(t, f), getattr(j, f), f)
    assert (t.replay_cycles, t.cycles) == (j.replay_cycles, j.cycles)
    assert t.rel_error == j.rel_error


# ---- the backend parity matrix ---------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", BACKENDS)
def test_backend_parity_matrix_across_packages(name, shape, precision):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, b = _int_valued(rng, (m, k)), _int_valued(rng, (k, n))
    jbe = jbackend.get_backend(name)
    tbe = tbackend.get_backend(name, device="cpu")
    j_out, j_tel = jbe.matmul(a, b, precision=precision)
    t_out, t_tel = tbe.matmul(a, b, precision=precision)
    assert t_out.dtype == torch.float32 and tuple(t_out.shape) == (m, n)
    assert np.array_equal(t_out.numpy(), np.asarray(j_out))
    i_out, _ = tbackend.get_backend("ideal", device="cpu").matmul(
        a, b, precision=precision)
    assert torch.equal(t_out, i_out)
    _same_tel(t_tel, j_tel)
    assert (t_tel.calls, t_tel.macs, t_tel.flags, t_tel.replays,
            t_tel.silent, t_tel.rel_error) == (1, m * k * n, 0, 0, 0, 0.0)
    assert (t_tel.energy_j > 0) == (name == "emulated")
    assert_same(tbe.summary(), jbe.summary(), "summary")


def test_native_precision_parity_across_packages():
    rng = np.random.default_rng(7)
    a, b = _int_valued(rng, (16, 24)), _int_valued(rng, (24, 8))
    for name in BACKENDS:
        j_out, j_tel = jbackend.get_backend(name).matmul(a, b)
        t_out, t_tel = tbackend.get_backend(name, device="cpu").matmul(a, b)
        assert t_out.dtype == torch.float32, name
        assert np.array_equal(t_out.numpy(), np.asarray(j_out)), name
        _same_tel(t_tel, j_tel)


def _undervolted(pkg, **kw):
    be = pkg.get_backend("emulated", **kw)
    v_safe = float(be.accel.timing.min_safe_voltage().max())
    be.accel.set_rails(np.full(be.accel.n_partitions, v_safe - 0.02))
    return be


@pytest.mark.parametrize("count_flags", [True, False])
def test_undervolted_emulated_reports_the_references_flags(count_flags):
    jbe, tbe = _undervolted(jbackend), _undervolted(tbackend, device="cpu")
    rng = np.random.default_rng(3 if count_flags else 4)
    a, b = rng.normal(size=(32, 8)), rng.normal(size=(8, 8))
    _, j_tel = jbe.matmul(a, b, count_flags=count_flags)
    _, t_tel = tbe.matmul(a, b, count_flags=count_flags)
    _same_tel(t_tel, j_tel)
    assert t_tel.replays > 0
    if count_flags:
        assert t_tel.flags > 0 and any(t_tel.partition_flags)
    else:
        assert t_tel.flags == 0 and t_tel.partition_flags is None
    assert_same(tbe.summary(), jbe.summary(), "summary")


def test_registry_backends_and_their_options():
    # with both resilience packages imported, "guarded" is in both
    import repro.resilience  # noqa: F401
    import repro_torch.resilience  # noqa: F401
    assert tbackend.available_backends() == jbackend.available_backends()
    t = tbackend.get_backend("simulated", array_n=4, tech="vtr-45nm",
                             device="cpu")
    j = jbackend.get_backend("simulated", array_n=4, tech="vtr-45nm")
    assert t.sim.timing.n == j.sim.timing.n == 4
    e = tbackend.get_backend("emulated", corruption="bitflip", device="cpu")
    assert e.device.type == "cpu" and e.accel.device.type == "cpu"
    assert e.accel.corruption == "bitflip"


# ---- hwloop device ----------------------------------------------------------


def _accels(reports, **kw):
    jrep, trep = reports
    return (jhw.EmulatedAccelerator.from_flow(
                jrep, jflow.FlowConfig(**CFG_KW), **kw),
            thw.EmulatedAccelerator.from_flow(
                trep, tflow.FlowConfig(**CFG_KW), device="cpu", **kw))


def _run_both(pair, a, w):
    (jacc, tacc) = pair
    jc, jtel = jacc.matmul(a, w)
    tc, ttel = tacc.matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert tc.dtype == torch.float64
    assert np.array_equal(tc.numpy(), jc)
    _same_mtel(ttel, jtel)
    assert_same(tacc.ledger.summary(), jacc.ledger.summary(), "ledger")
    return tc.numpy(), ttel


def _nominal_rails(reports):
    return np.full(reports[0].n_partitions,
                   jflow.FlowConfig(**CFG_KW).node.v_nom)


def test_device_nominal_is_ideal_and_accounts(reports):
    pair = _accels(reports, rails=_nominal_rails(reports))
    rng = np.random.default_rng(0)
    a, w = rng.normal(size=(32, 8)), rng.normal(size=(8, 8))
    c, tel = _run_both(pair, a, w)
    assert np.array_equal(c, a @ w) and tel.rel_error == 0.0
    led = pair[1].ledger
    assert led.dynamic_j > 0 and led.leakage_j > 0
    assert led.total_macs == 32 * 8 * 8 and led.replay_cycles == 0
    # host arrays are put on the device; results are tensors there
    c2, _ = pair[1].matmul(a, w)
    assert isinstance(c2, torch.Tensor) and c2.device.type == "cpu"


def test_device_multi_tile_shapes_cover_all_macs(reports):
    pair = _accels(reports, rails=_nominal_rails(reports))
    rng = np.random.default_rng(1)
    a, w = rng.normal(size=(5, 20)), rng.normal(size=(20, 13))
    _, tel = _run_both(pair, a, w)
    assert tel.macs_p.sum() == 5 * 20 * 13


def test_device_undervolt_raises_the_partitions_rate(reports):
    pair = _accels(reports)
    rng = np.random.default_rng(2)
    a, w = rng.normal(size=(32, 8)), rng.normal(size=(8, 8))
    _, before = _run_both(pair, a, w)
    jacc, tacc = pair
    v_safe = float(tacc.timing.min_safe_voltage()[tacc._part_grid == 0].max())
    for acc in pair:
        acc.set_partition_voltage(0, v_safe - 0.02)
    _, after = _run_both(pair, a, w)
    assert after.detected_rate[0] > before.detected_rate[0]
    assert after.partition_flags[0]
    np.testing.assert_array_equal(after.partition_flags[1:],
                                  before.partition_flags[1:])


def test_device_rails_validation(reports):
    for make in (lambda: jhw.EmulatedAccelerator.from_flow(
                     reports[0], jflow.FlowConfig(**CFG_KW),
                     rails=np.array([1.0])),
                 lambda: thw.EmulatedAccelerator.from_flow(
                     reports[1], tflow.FlowConfig(**CFG_KW),
                     rails=np.array([1.0]), device="cpu")):
        with pytest.raises(ValueError, match="rail"):
            make()


@pytest.mark.parametrize("corruption", ["stale", "tedrop", "bitflip"])
@pytest.mark.parametrize("integer", [False, True], ids=["real", "integer"])
def test_device_corruption_models_equal_the_reference(reports, corruption,
                                                      integer):
    pair = _accels(reports, rails=np.full(reports[0].n_partitions, V_CRASH),
                   corruption=corruption)
    rng = np.random.default_rng(3)
    a, w = rng.normal(size=(16, 20)), rng.normal(size=(20, 12))
    if integer:
        a, w = np.round(3 * a), np.round(3 * w)
    c, tel = _run_both(pair, a, w)
    assert tel.silent_p.sum() > 0 and tel.rel_error > 0
    assert not np.array_equal(c, a @ w) and np.isfinite(c).all()


def test_device_tedrop_drops_failing_terms(reports):
    pair = _accels(reports, rails=np.full(reports[0].n_partitions, V_CRASH),
                   corruption="tedrop")
    rng = np.random.default_rng(3)
    a, w = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    c, _ = _run_both(pair, a, w)
    from repro_torch.core.razor import (SILENT, classify_arrival,
                                        effective_arrival)
    acc = pair[1]
    act = thw.quantized_activity(a, acc.quant_bits)
    arrival = effective_arrival(acc.timing.delays_at(acc.v_map)[None],
                                act[:, :, None], acc.razor)
    sil = classify_arrival(arrival, acc.razor) == SILENT
    terms = a[:, :, None] * w[None, :, :]
    np.testing.assert_array_equal(c, np.where(sil, 0.0, terms).sum(axis=1))


def test_device_stale_matches_the_simulator(reports):
    from repro_torch.core import RazorConfig, SystolicSim, TimingModel
    cfg = tflow.FlowConfig(**CFG_KW)
    tm = TimingModel(n=8, clock_ns=cfg.clock_ns, tech=cfg.node, seed=cfg.seed)
    fp = reports[1].floorplan.with_voltages([V_CRASH] * 4)
    sim = SystolicSim(tm, fp, RazorConfig(clock_ns=cfg.clock_ns))
    acc = thw.EmulatedAccelerator(tm, fp,
                                  razor=RazorConfig(clock_ns=cfg.clock_ns),
                                  corruption="stale", device="cpu")
    rng = np.random.default_rng(4)
    a, w = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    c_sim, stats = sim.matmul(a, w)
    c_emu, tel = acc.matmul(a, w)
    np.testing.assert_array_equal(c_emu.numpy(), c_sim)
    assert tel.silent_p.sum() == stats.silent.sum()
    assert tel.replay_cycles == stats.replay_cycles


def test_device_energy_tracks_voltage_and_replays(reports):
    pair = _accels(reports, rails=_nominal_rails(reports))
    rng = np.random.default_rng(5)
    a, w = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    _run_both(pair, a, w)
    assert pair[1].ledger.replay_j == 0.0
    v_safe = float(pair[1].timing.min_safe_voltage().max())
    for acc in pair:
        acc.set_rails(np.full(reports[0].n_partitions, v_safe - 0.02))
    _, tel = _run_both(pair, a, w)
    assert tel.replay_cycles > 0 and pair[1].ledger.replay_j > 0.0


def test_device_energy_per_token_needs_token_attribution(reports):
    pair = _accels(reports, rails=_nominal_rails(reports))
    rng = np.random.default_rng(6)
    _run_both(pair, rng.normal(size=(8, 8)), rng.normal(size=(8, 8)))
    assert pair[1].ledger.energy_per_token_j is None
    for acc in pair:
        acc.ledger.add_tokens(4)
    assert pair[1].ledger.energy_per_token_j == \
        pair[0].ledger.energy_per_token_j > 0


def test_energy_ledger_totals_bit_equal():
    from repro.core import model_for as j_model_for
    from repro_torch.core import model_for as t_model_for
    leds = [thw.EnergyLedger(power=t_model_for("vtr-22nm"), clock_ns=10.0,
                             array_n=8, n_partitions=4),
            jhw.EnergyLedger(power=j_model_for("vtr-22nm"), clock_ns=10.0,
                             array_n=8, n_partitions=4)]
    rng = np.random.default_rng(8)
    for _ in range(20):
        macs = rng.integers(0, 10_000, 4)
        rails = rng.uniform(0.6, 1.0, 4)
        replays = rng.integers(0, 50, 4)
        cycles = int(rng.integers(1, 5000))
        for led in leds:
            led.record(macs, rails, replays, cycles)
    for led in leds:
        led.add_tokens(7)
    assert_same(leds[0].summary(), leds[1].summary(), "ledger")


# ---- inject -----------------------------------------------------------------


def test_corruption_registry():
    assert sorted(tinject.CORRUPTION_MODELS) == \
        sorted(jinject.CORRUPTION_MODELS)
    assert sorted(tinject.TILE_MODELS) == sorted(tinject.CORRUPTION_MODELS)
    assert tinject.get_corruption("stale") is tinject.stale_psum
    assert tinject.get_tile_corruption("stale") is tinject.stale_psum_tiles
    for get in (tinject.get_corruption, tinject.get_tile_corruption):
        with pytest.raises(KeyError, match="unknown corruption model"):
            get("bit_flip")
    tinject.register_corruption("host_only")(tinject.te_drop)
    try:
        with pytest.raises(KeyError, match="no torch tile form"):
            tinject.get_tile_corruption("host_only")
    finally:
        del tinject.CORRUPTION_MODELS["host_only"]


def _terms(seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        a = rng.integers(-3, 4, size=(6, 4)).astype(np.float64)
        w = rng.integers(-3, 4, size=(4, 5)).astype(np.float64)
    else:
        a, w = rng.normal(size=(6, 4)), rng.normal(size=(4, 5))
    silent = rng.random((6, 4, 5)) < 0.2
    silent[0, 1, 2] = True                   # a silent MAC in row 0
    return a[:, :, None] * w[None, :, :], silent


@pytest.mark.parametrize("name", ["stale", "tedrop", "bitflip"])
@pytest.mark.parametrize("integer", [False, True], ids=["real", "integer"])
def test_corruption_models_equal_the_reference(name, integer):
    terms, silent = _terms(11, integer)
    rng = np.random.default_rng(0)
    j = jinject.get_corruption(name)(terms, silent, rng)
    t = tinject.get_corruption(name)(terms, silent, rng)
    assert np.array_equal(t, j)
    # the tile form on a batch of two tiles: the same per tile
    batch = torch.from_numpy(np.stack([terms, terms[::-1].copy()]))
    mask = torch.from_numpy(np.stack([silent, silent[::-1].copy()]))
    out = tinject.get_tile_corruption(name)(batch, mask, None)
    assert out.shape == (2, 6, 5) and out.dtype == torch.float64
    second = jinject.get_corruption(name)(terms[::-1].copy(),
                                          silent[::-1].copy(), rng)
    for got, want in ((out[0].numpy(), j), (out[1].numpy(), second)):
        if integer or name == "stale":
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())


def test_tile_forms_exact_when_nothing_is_silent():
    terms, _ = _terms(12, True)
    batch = torch.from_numpy(terms[None])
    exact = torch.from_numpy(terms.sum(axis=1))
    for name in ("stale", "tedrop", "bitflip"):
        out = tinject.get_tile_corruption(name)(
            batch, torch.zeros(batch.shape, dtype=torch.bool), None)
        assert torch.equal(out[0], exact), name


def _corrupted_fraction(accel, rounds=6, seed=3):
    rng = np.random.default_rng(seed)
    bad = total = 0
    for _ in range(rounds):
        a = rng.integers(-4, 5, size=(16, 8)).astype(np.float64)
        w = rng.integers(-4, 5, size=(8, 8)).astype(np.float64)
        out, _ = accel.matmul(a, w)
        out = out.numpy() if isinstance(out, torch.Tensor) else out
        bad += int(np.sum(out != a @ w))
        total += out.size
    return bad / total


def test_corruption_rate_scales_with_undervolt_as_the_reference():
    rates = []
    for accel in (jbackend.EmulatedBackend.nominal(corruption="bitflip").accel,
                  tbackend.EmulatedBackend.nominal(corruption="bitflip",
                                                   device="cpu").accel):
        v_nom = float(accel.timing.tech.v_nom)
        row = []
        for v in (v_nom, 0.66, V_CRASH):
            accel.set_rails(np.full(accel.n_partitions, v))
            row.append(_corrupted_fraction(accel))
        rates.append(row)
    assert rates[0] == rates[1]
    assert rates[1][0] == 0.0 < rates[1][-1] and rates[1] == sorted(rates[1])


# ---- session ----------------------------------------------------------------


SESSION_CFG = dict(array_n=8, tech="vtr-22nm", max_trials=12, seed=2021)


def _sessions():
    return (jhw.HwLoopSession(jflow.FlowConfig(**SESSION_CFG), patience=2,
                              rail_margin=0.05, probe_rows=8),
            thw.HwLoopSession(tflow.FlowConfig(**SESSION_CFG), patience=2,
                              rail_margin=0.05, probe_rows=8, device="cpu"))


def _step_both(sessions, tokens, **kw):
    jt, tt = (s.step(tokens, **kw) for s in sessions)
    assert_same(
        (tt.flags, tt.detected_p, tt.silent_p, tt.rel_error, tt.recalibrated),
        (jt.flags, jt.detected_p, jt.silent_p, jt.rel_error, jt.recalibrated),
        "step")
    return tt


def test_session_clean_steps_equal_the_reference():
    sessions = _sessions()
    for i in range(4):
        tel = _step_both(sessions, [3 + i, 11 * i])
        assert not tel.flags.any() and tel.rel_error == 0.0
    assert_same(sessions[1].summary(), sessions[0].summary(), "summary")
    assert sessions[1].summary()["tokens"] == 8


def test_session_undervolt_flags_then_heals_at_the_references_step():
    sessions = _sessions()
    _step_both(sessions, [5])
    acc = sessions[1].accel
    v_safe = float(acc.timing.min_safe_voltage()[acc._part_grid == 0].max())
    for s in sessions:
        s.set_partition_voltage(0, v_safe - 0.02)
    recal_at = None
    for i in range(6):
        tel = _step_both(sessions, [17, i])
        if tel.recalibrated:
            recal_at = i
            break
        assert tel.flags[0]
    assert recal_at is not None and sessions[1].recalibrations == 1
    assert_same(sessions[1].rails, sessions[0].rails, "healed rails")
    assert sessions[1].rails[0] > v_safe - 0.02
    np.testing.assert_allclose(
        sessions[1].rails, np.asarray(sessions[1].watchdog.runtime_v) + 0.05)
    assert not _step_both(sessions, [23]).flags.any()
    assert_same(sessions[1].summary(), sessions[0].summary(), "summary")


def test_session_recalibration_reuses_cached_prefix():
    session = _sessions()[1]
    acc = session.accel
    v_safe = float(acc.timing.min_safe_voltage()[acc._part_grid == 0].max())
    session.set_partition_voltage(0, v_safe - 0.02)
    for _ in range(4):
        if session.step([9]).recalibrated:
            break
    store = session.watchdog.store
    assert session.recalibrations == 1
    for stage in ("timing", "cluster", "floorplan", "static_voltage"):
        assert store.runs_of(stage) == 1, stage
    assert store.runs_of("runtime_calibration") == 2


def test_session_step_shapes_clamping_and_rejections():
    session = _sessions()[1]
    tel = session.step([1, 2, 3], n_tokens=3)
    assert tel.flags.shape == tel.detected_p.shape == (session.n_partitions,)
    assert session.accel.ledger.tokens == 3
    for bad in (float("nan"), float("inf")):
        with pytest.raises(ValueError, match="non-finite"):
            session.set_partition_voltage(0, bad)
    for bad_p in (-1, session.n_partitions):
        with pytest.raises(IndexError, match="out of range"):
            session.set_partition_voltage(bad_p, 0.9)
    lo, hi = session.rail_envelope
    session.set_partition_voltage(0, lo - 1.0)
    assert session.rails[0] == lo
    session.set_partition_voltage(0, hi + 1.0)
    assert session.rails[0] == hi
    session.set_partition_voltage(0, 0.9)
    assert session.rails[0] == 0.9


def test_session_gauges_republish_on_a_manual_write():
    from repro_torch.obs import ObsBus
    session = _sessions()[1]
    bus = ObsBus()
    session.attach_obs(bus)
    gauge = bus.registry.gauge("hwloop_rail_volts", labels=("partition",))
    assert gauge.value(partition="0") == session.rails[0]
    session.set_partition_voltage(0, 0.91)
    assert gauge.value(partition="0") == pytest.approx(0.91)


# ---- watchdog and monitor ---------------------------------------------------


def _watchdogs(**kw):
    return (jrt.CalibrationWatchdog(jflow.FlowConfig(**SESSION_CFG), **kw),
            trt.CalibrationWatchdog(tflow.FlowConfig(**SESSION_CFG), **kw))


def _observe(dogs, flags):
    j, t = (d.observe(flags) for d in dogs)
    assert (j is None) == (t is None)
    if t is not None:
        assert_same(t.runtime_v, j.runtime_v, "recalibrated rails")
    return t


def test_watchdog_initial_calibration():
    dogs = _watchdogs(patience=2)
    assert_same(dogs[1].runtime_v, dogs[0].runtime_v, "rails")
    assert dogs[1].recalibrations == 0
    assert not dogs[1].needs_recalibration().any()


def test_watchdog_recalibrates_on_persistent_flags():
    dogs = _watchdogs(patience=2)
    p = dogs[1].report.n_partitions
    noisy = [True] + [False] * (p - 1)
    assert _observe(dogs, [False] * p) is None
    assert _observe(dogs, noisy) is None
    assert _observe(dogs, noisy) is not None
    assert dogs[1].recalibrations == 1
    assert dogs[1].store.runs_of("timing") == 1
    assert dogs[1].store.runs_of("runtime_calibration") == 2


def test_watchdog_transient_flags_are_tolerated():
    dogs = _watchdogs(patience=2)
    p = dogs[1].report.n_partitions
    for flags in ([True] * p, [False] * p, [True] * p):
        assert _observe(dogs, flags) is None
    assert dogs[1].recalibrations == 0


def test_watchdog_rejects_wrong_flag_count():
    for dog in _watchdogs(patience=2):
        with pytest.raises(ValueError, match="partition flags"):
            dog.observe([True])


def test_watchdog_unconverged_retries_are_bounded(monkeypatch):
    dogs = _watchdogs(patience=2, max_unconverged_retries=2)
    p = dogs[1].report.n_partitions
    for d in dogs:
        monkeypatch.setattr(
            type(d), "needs_recalibration",
            lambda self: np.ones(self.report.n_partitions, dtype=bool))
    assert _observe(dogs, [False] * p) is not None
    assert _observe(dogs, [False] * p) is not None
    assert _observe(dogs, [False] * p) is None
    assert dogs[1].recalibrations == 2
    assert _observe(dogs, [True] * p) is None
    assert _observe(dogs, [True] * p) is not None


def test_watchdog_recalibration_reuses_cached_upstream_artifacts():
    dogs = _watchdogs(patience=1)
    wd = dogs[1]
    p = wd.report.n_partitions
    for stage in ("timing", "cluster", "floorplan", "static_voltage",
                  "runtime_calibration", "power"):
        assert wd.store.runs_of(stage) == 1, stage
    hits = {s: wd.store.stats[s].hits for s in ("timing", "cluster",
                                                 "floorplan")}
    assert _observe(dogs, [True] + [False] * (p - 1)) is not None
    for stage in ("timing", "cluster", "floorplan", "static_voltage"):
        assert wd.store.runs_of(stage) == 1, stage
    for stage, before in hits.items():
        assert wd.store.stats[stage].hits > before, stage
    assert wd.store.runs_of("runtime_calibration") == 2
    assert_same(wd.store.summary(), dogs[0].store.summary(), "store")


def test_heartbeat_monitor_and_elastic_remap_equal():
    out = []
    for rt in (jrt, trt):
        mon = rt.HeartbeatMonitor(num_hosts=6, timeout_steps=2)
        for step in range(8):
            for h in range(6):
                if h == 4 and step > 3:
                    continue                       # host 4 goes silent
                mon.beat(h, step, 1.0 + (2.5 if h == 2 else 0.01 * h))
            mon.stragglers()
        dead = mon.check_dead(8)
        plan = rt.plan_elastic_remap(mon.alive_hosts(), model_parallel=2,
                                     hosts_per_dp_group=2)
        out.append((dead, [(s.host_id, s.z_score) for s in mon.stragglers()],
                    plan.data_parallel, plan.host_to_shard,
                    plan.dropped_hosts, plan.world))
    assert out[0] == out[1]


# ---- the flow stage ---------------------------------------------------------


STAGE_KW = dict(array_n=8, max_trials=8, seed=2021, hwloop_steps=4,
                hwloop_rows=8)


def test_hwloop_stage_is_registered_and_opt_in():
    assert tflow.get_stage("hwloop").name == "hwloop"
    assert tflow.get_stage("hwloop").device is None           # the GPU
    pipe = thw.hwloop_pipeline(device="cpu")
    names = [s.name for s in pipe.stages]
    assert names == [s.name for s in jhw.hwloop_pipeline().stages]
    assert names.index("hwloop") == names.index("power") + 1
    assert "hwloop" not in [s.name for s in tflow.Pipeline().stages]


@pytest.mark.parametrize("backend", ["emulated", "simulated", "reference"])
def test_hwloop_stage_artifacts_equal_the_references(backend):
    kw = dict(STAGE_KW, backend=backend,
              hwloop_corruption="tedrop" if backend == "emulated" else "stale")
    j = jflow.run(jflow.FlowConfig(**kw), pipeline=jhw.hwloop_pipeline())
    t = tflow.run(tflow.FlowConfig(**kw),
                  pipeline=thw.hwloop_pipeline(device="cpu"))
    assert_same(t, j, "report")
    if backend == "emulated":
        assert t.hwloop_energy_per_token_j > 0
    assert len(t.hwloop_flag_rate) == t.n_partitions


def test_hwloop_sweep_rows_and_table_equal():
    base = (jflow.FlowConfig(**STAGE_KW), tflow.FlowConfig(**STAGE_KW))
    j = jflow.sweep({"tech": ["vtr-22nm", "vtr-45nm"]}, base[0],
                    pipeline=jhw.hwloop_pipeline())
    t = tflow.sweep({"tech": ["vtr-22nm", "vtr-45nm"]}, base[1],
                    pipeline=thw.hwloop_pipeline(device="cpu"))
    assert_same(t.rows(), j.rows(), "rows")
    assert t.table() == j.table()
    assert "hwloop_energy_per_token_j" in t.table().splitlines()[0]


# ---- the serve engine -------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    from repro.configs import get_config as j_get_config
    from repro.models import model_api as j_model_api
    from repro_torch.configs import get_config
    from repro_torch.models import model_api, params_from_numpy
    from test_torch_serve import _np_tree
    jcfg = j_get_config("starcoder2-3b", smoke=True)
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = get_config("starcoder2-3b", smoke=True)
    tparams = params_from_numpy(
        _np_tree(jparams), model_api(tcfg, device="cpu").param_specs(), "cpu")
    return jcfg, jparams, tcfg, tparams


def _drain(engine_cls, request_cls, cfg, params, n_req=2, max_new=3, **kw):
    eng = engine_cls(cfg, params, slots=2, max_len=32, **kw)
    reqs = [request_cls(uid=i, prompt=[3 + i, 4 + i], max_new_tokens=max_new)
            for i in range(n_req)]
    for r in reqs:
        eng.submit(r)
    return eng, eng.run_until_drained(), reqs


def _engines():
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import Request, ServeEngine
    return (JServeEngine, JRequest), (ServeEngine, Request)


ACCOUNTING = ("prefill_steps", "decode_steps", "admitted", "completed",
              "tokens_generated", "slot_busy_steps", "backend")


def test_engine_serves_every_gemm_on_the_emulated_backend(dense):
    jcfg, jparams, tcfg, tparams = dense
    (je, jr), (te, tr) = _engines()
    _, jstats, _ = _drain(je, jr, jcfg, jparams,
                          backend=jbackend.get_backend("emulated"))
    be = tbackend.get_backend("emulated", device="cpu")
    _, stats, reqs = _drain(te, tr, tcfg, tparams, backend=be, device="cpu")
    jd, td = jstats.to_dict(), stats.to_dict()
    assert list(td) == list(jd)
    for key in ACCOUNTING:
        assert td[key] == jd[key], key
    assert len(stats.backend_step_flags) == stats.decode_steps
    assert not any(any(f) for f in stats.backend_step_flags)
    bt, jbt = td["backend_telemetry"], jd["backend_telemetry"]
    assert list(bt) == list(jbt)
    for key in ("backend", "calls", "macs", "flags", "replays", "silent",
                "tokens", "device_macs", "rails_v", "corruption"):
        assert bt[key] == jbt[key], key
    assert bt["tokens"] == stats.tokens_generated - stats.admitted
    assert bt["energy_per_token_j"] > 0
    json.dumps(td)


def test_engine_thin_adapter_undervolt_then_heal(dense):
    *_, tcfg, tparams = dense
    _, (te, tr) = _engines()
    session = thw.HwLoopSession(tflow.FlowConfig(**CFG_KW), probe_rows=8,
                                rail_margin=0.02, patience=2, device="cpu")
    be = tbackend.EmulatedBackend(session.accel)
    _, stats, _ = _drain(te, tr, tcfg, tparams, n_req=3, max_new=4,
                         backend=be, hwloop=session, device="cpu")
    assert session.steps == stats.decode_steps
    assert stats.hwloop_step_flags == stats.backend_step_flags
    assert stats.hwloop["steps"] == stats.decode_steps
    v_safe = float(be.accel.timing.min_safe_voltage()
                   [be.accel._part_grid == 0].max())
    session.set_partition_voltage(0, v_safe - 0.02)
    _, stats2, _ = _drain(te, tr, tcfg, tparams, n_req=3, max_new=4,
                          backend=be, hwloop=session, device="cpu")
    flagged = [f[0] for f in stats2.backend_step_flags]
    assert any(flagged) and session.recalibrations >= 1
    assert be.accel.rails[0] > v_safe - 0.02
    # healed: the flag rate is zero from the heal on
    _, stats3, _ = _drain(te, tr, tcfg, tparams, n_req=3, max_new=4,
                          backend=be, hwloop=session, device="cpu")
    assert not any(any(f) for f in stats3.backend_step_flags)


def test_engine_surfaces_probe_hwloop_telemetry_as_the_reference(dense):
    jcfg, jparams, tcfg, tparams = dense
    (je, jr), (te, tr) = _engines()
    j_session = jhw.HwLoopSession(jflow.FlowConfig(**CFG_KW), probe_rows=8,
                                  rail_margin=0.02)
    t_session = thw.HwLoopSession(tflow.FlowConfig(**CFG_KW), probe_rows=8,
                                  rail_margin=0.02, device="cpu")
    _, jstats, jreqs = _drain(je, jr, jcfg, jparams, n_req=3,
                              hwloop=j_session)
    _, stats, reqs = _drain(te, tr, tcfg, tparams, n_req=3,
                            hwloop=t_session, device="cpu")
    assert len(stats.hwloop_step_flags) == stats.decode_steps
    hw = stats.hwloop
    assert hw["steps"] == stats.decode_steps
    assert hw["tokens"] == stats.tokens_generated - stats.admitted
    assert hw["energy_per_token_j"] > 0
    # the probe traffic is drawn from the served tokens (equal here, no
    # logits lie within the two stacks' noise), so the ledger is equal too
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert_same(hw, jstats.hwloop, "hwloop summary")
    json.dumps(stats.to_dict())


def test_outputs_unchanged_by_emulation(dense):
    *_, tcfg, tparams = dense
    _, (te, tr) = _engines()

    def drain(hwloop):
        _, _, reqs = _drain(te, tr, tcfg, tparams, n_req=3, hwloop=hwloop,
                            device="cpu")
        return [r.out_tokens for r in reqs]

    session = thw.HwLoopSession(tflow.FlowConfig(**CFG_KW), probe_rows=8,
                                rail_margin=0.02, device="cpu")
    assert drain(None) == drain(session)


# ---- the launcher -----------------------------------------------------------


@pytest.mark.parametrize("flags", [["--backend", "emulated"],
                                   ["--backend", "simulated"],
                                   ["--backend", "emulated", "--hwloop"]],
                         ids=["emulated", "simulated", "emulated-hwloop"])
def test_launcher_writes_the_jax_launchers_json(flags, tmp_path, monkeypatch,
                                                capsys):
    from repro.launch import serve as j_launch
    from repro_torch.launch import serve as t_launch
    base = ["--arch", "phi4-mini-3.8b", "--smoke", "--requests", "3",
            "--slots", "2", "--max-new", "3"] + flags
    t_out, j_out = tmp_path / "torch.json", tmp_path / "jax.json"
    t_launch.main(base + ["--device", "cpu", "--json-out", str(t_out)])
    t_print = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + base
                        + ["--json-out", str(j_out)])
    j_launch.main()
    j_print = capsys.readouterr().out
    t, j = json.loads(t_out.read_text()), json.loads(j_out.read_text())
    assert list(t) == list(j)
    for key in ("arch", "engine", "slots", "max_len", "requests",
                "prefill_steps", "decode_steps", "admitted", "completed",
                "truncated", "tokens_generated", "slot_busy_steps", "backend",
                "model_steps", "occupancy"):
        assert t[key] == j[key], key
    bt, jbt = t["backend_telemetry"], j["backend_telemetry"]
    assert list(bt) == list(jbt)
    for key in ("backend", "calls", "macs", "flags", "replays", "silent"):
        assert bt[key] == jbt[key], key
    if "--hwloop" in flags:
        assert list(t["hwloop"]) == list(j["hwloop"])
        for key in ("steps", "recalibrations", "rail_margin_v", "corruption",
                    "tokens"):
            assert t["hwloop"][key] == j["hwloop"][key], key
    for tag in ("[backend:", "[hwloop]"):
        assert (tag in t_print) == (tag in j_print), tag
