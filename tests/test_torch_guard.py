"""The port's ABFT guard (``repro_torch.resilience``) and its checksum
kernel's plain version against ``repro.resilience``, on the CPU.

Every case of ``tests/resilience/test_guard.py`` runs in both packages on the
same numpy-made operands: outputs bit for bit, and the ``guard_*`` counters,
``calls``, flags, rails, recalibrations and the Freivalds generator's state
equal.  Then the reference's ``silent_burst`` and ``watchdog_delay`` chaos
scripts on a guarded starcoder2 smoke engine in both packages (streams equal
to the port's unguarded decode, and to the reference's up to ties; the same
guard counters, step events, rails and recalibrations); and the
checksum module: its plain version against ``guard.py``'s numpy GEMVs, and
the kernel's launch plan with the wrapper's routes, each launch emulated in
the kernel's order (``test_torch_abft_plan.py``).
"""

import types

import jax
import numpy as np
import pytest
import torch

import repro.backend as jbackend
import repro.resilience as jres
import repro_torch.backend as tbackend
import repro_torch.resilience as tres
from repro.obs import ObsBus as JObsBus
from repro.resilience.chaos import V_CRASH as J_V_CRASH
from repro_torch.kernels import abft as abft_mod
from repro_torch.obs import ObsBus
from test_torch_core import assert_same

SHAPES = [(8, 8, 8), (16, 24, 8), (12, 40, 20)]
CFG_KW = dict(array_n=8, tech="vtr-22nm", max_trials=8, seed=2021)
#: the checksum kernel's float64 sums, taken in another order than numpy's,
#: against guard.py's GEMVs, relative to the sums of magnitudes
TOL_CHECKSUM = 1e-12

# the two packages behind one interface: backends are made on the CPU
JAX = types.SimpleNamespace(be=jbackend, res=jres, kw={}, obs=JObsBus,
                            name="jax")
TORCH = types.SimpleNamespace(be=tbackend, res=tres, kw={"device": "cpu"},
                              obs=ObsBus, name="torch")


def _int_ops(m, k, n, seed):
    """Integer-valued f32 operands: f64 checksums are exact, so a verified
    product is bit-identical to the ideal one."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, size=(m, k)).astype(np.float32),
            rng.integers(-4, 5, size=(k, n)).astype(np.float32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _crashed_guard(pkg, corruption="bitflip", **kw):
    guard = pkg.res.GuardedBackend(
        pkg.be.EmulatedBackend.nominal(corruption=corruption, **pkg.kw), **kw)
    accel = guard.accel
    accel.set_rails(np.full(accel.n_partitions, tres.V_CRASH))
    return guard


def _same_tel(t, j):
    assert_same(t.to_dict(), j.to_dict(), "telemetry")


def _both(fn):
    """``fn(pkg)`` for the port and for the reference."""
    return fn(TORCH), fn(JAX)


def test_v_crash_is_the_references():
    assert tres.V_CRASH == J_V_CRASH
    # the reference's names (the guard and the chaos campaign) and V_CRASH
    assert sorted(tres.__all__) == sorted(jres.__all__ + ["V_CRASH"])
    assert tres.guard.MODES == jres.guard.MODES
    assert tres.guard.POLICIES == jres.guard.POLICIES


# ---- acceptance: bit-identical restoration under silent corruption ----------


@pytest.mark.parametrize("corruption", ["bitflip", "stale", "tedrop"])
@pytest.mark.parametrize("shape", SHAPES, ids=["%dx%dx%d" % s for s in SHAPES])
def test_guard_restores_bit_identical_outputs(corruption, shape):
    m, k, n = shape
    a, b = _int_ops(m, k, n, seed=m + k + n)
    ref, _ = tbackend.IdealBackend(device="cpu").matmul(a, b)

    def raw(pkg):
        be = pkg.be.EmulatedBackend.nominal(corruption=corruption, **pkg.kw)
        be.accel.set_rails(np.full(be.accel.n_partitions, tres.V_CRASH))
        return be.matmul(a, b)

    (t_raw, t_rtel), (j_raw, j_rtel) = _both(raw)
    assert np.array_equal(_np(t_raw), _np(j_raw))
    _same_tel(t_rtel, j_rtel)
    assert not np.array_equal(_np(t_raw), ref.numpy())

    def guarded(pkg):
        guard = _crashed_guard(pkg, corruption=corruption)
        out, tel = guard.matmul(a, b)
        return guard, out, tel

    (tg, t_out, t_tel), (jg, j_out, j_tel) = _both(guarded)
    assert np.array_equal(t_out.numpy(), ref.numpy())
    assert np.array_equal(t_out.numpy(), _np(j_out))
    _same_tel(t_tel, j_tel)
    assert t_tel.guard_detected >= 1 and t_tel.guard_heals == 1
    assert t_tel.guard_uncorrected == 0 and t_tel.calls == 1
    assert np.array_equal(tg.accel.rails, jg.accel.rails)
    assert float(tg.accel.rails.min()) > tres.V_CRASH
    assert_same(tg.summary(), jg.summary(), "summary")


def test_heal_restores_nominal_rails_without_session():
    a, b = _int_ops(8, 8, 8, seed=1)

    def run(pkg):
        guard = _crashed_guard(pkg)
        guard.matmul(a, b)
        return guard

    tg, jg = _both(run)
    assert np.allclose(tg.accel.rails, float(tg.accel.timing.tech.v_nom))
    assert np.array_equal(tg.accel.rails, jg.accel.rails)
    _same_tel(tg.total, jg.total)


def test_heal_via_attached_session_watchdog():
    import repro.flow as jflow
    import repro.hwloop as jhw
    import repro_torch.flow as tflow
    import repro_torch.hwloop as thw
    a, b = _int_ops(8, 8, 8, seed=2)
    ref = a.astype(np.float64) @ b.astype(np.float64)

    def run(pkg):
        flow, hw = (tflow, thw) if pkg is TORCH else (jflow, jhw)
        session = hw.HwLoopSession(flow.FlowConfig(**CFG_KW), probe_rows=8,
                                   rail_margin=0.02, patience=2, **pkg.kw)
        guard = pkg.res.GuardedBackend(pkg.be.EmulatedBackend(session.accel),
                                       session=session)
        session.accel.set_rails(np.full(session.accel.rails.shape[0],
                                        tres.V_CRASH))
        out, tel = guard.matmul(a, b)
        return session, out, tel

    (ts, t_out, t_tel), (js, j_out, j_tel) = _both(run)
    assert np.array_equal(t_out.numpy(), ref.astype(np.float32))
    assert np.array_equal(t_out.numpy(), _np(j_out))
    _same_tel(t_tel, j_tel)
    assert t_tel.guard_heals == 1
    assert ts.recalibrations == js.recalibrations >= 1
    assert np.array_equal(ts.accel.rails, js.accel.rails)
    assert float(ts.accel.rails.min()) > tres.V_CRASH


# ---- locate-and-correct -----------------------------------------------------


def _flaky_ideal(pkg, n_bad=1, delta=7.0, at=((2, 3),)):
    """An ideal inner whose first ``n_bad`` executions add ``delta`` at each
    position of ``at`` — one element is the signature ABFT corrects without
    re-execution."""
    inner = pkg.be.IdealBackend(**pkg.kw)
    real = inner._execute
    calls = {"n": 0}

    def bump(out):
        calls["n"] += 1
        if calls["n"] <= n_bad:
            for pos in at:
                out[pos] += delta
        return out

    if pkg is TORCH:
        def flaky(a, b, count_flags, counter):
            out, tel = real(a, b, count_flags, counter)
            return bump(out.to(torch.float64, copy=True)), tel
    else:
        def flaky(a, b):
            out, tel = real(a, b)
            return bump(np.asarray(out, dtype=np.float64).copy()), tel

    inner._execute = flaky
    return inner, calls


@pytest.mark.parametrize("mode", ["abft", "freivalds"])
def test_flaky_element_corrected_or_retried(mode):
    a, b = _int_ops(8, 8, 8, seed=3 if mode == "abft" else 4)
    exact = a.astype(np.float64) @ b.astype(np.float64)

    def run(pkg):
        inner, calls = _flaky_ideal(pkg)
        guard = pkg.res.GuardedBackend(inner, mode=mode)
        out, tel = guard.matmul(a, b)
        return guard, calls["n"], out, tel

    (tg, t_n, t_out, t_tel), (jg, j_n, j_out, j_tel) = _both(run)
    assert np.array_equal(t_out.numpy(), exact.astype(np.float32))
    assert np.array_equal(t_out.numpy(), _np(j_out))
    _same_tel(t_tel, j_tel)
    assert t_tel.guard_detected == 1
    if mode == "abft":           # corrected WITHOUT re-execution
        assert t_n == j_n == 1
        assert t_tel.guard_corrected == 1 and t_tel.guard_retries == 0
    else:                        # detection only: one retry cleared it
        assert t_n == j_n == 2
        assert t_tel.guard_retries == 1 and t_tel.guard_corrected == 0
    # the same probe sequence drawn from the same generator
    assert tg._rng.bit_generator.state == jg._rng.bit_generator.state


def test_freivalds_draws_the_references_probes_over_many_calls():
    """Passing and failing probes interleaved: the generator stays in step
    with the reference's loop, which stops drawing at the first failure.
    Two corrupted elements of one row cancel in a probe half the time, so
    the first failing probe is not always the first."""
    ops = [_int_ops(6, 10, 12, seed=s) for s in range(4)]

    def run(pkg):
        inner, _ = _flaky_ideal(pkg, n_bad=3, delta=1.0,
                                at=((1, 5), (1, 7)))
        guard = pkg.res.GuardedBackend(inner, mode="freivalds", probes=3,
                                       seed=5, max_retries=1, heal=False,
                                       policy="fail_open")
        states = []
        for a, b in ops:
            _, tel = guard.matmul(a, b)
            states.append((guard._rng.bit_generator.state, tel.to_dict()))
        return states

    t_states, j_states = _both(run)
    for (ts, tt), (js, jt) in zip(t_states, j_states):
        assert ts == js
        assert_same(tt, jt, "telemetry")


# ---- policy rungs -----------------------------------------------------------


def test_fail_closed_raises_with_the_flight_recorder():
    a, b = _int_ops(8, 8, 8, seed=5)

    def run(pkg):
        inner, _ = _flaky_ideal(pkg, n_bad=10 ** 9)      # corrupts forever
        guard = pkg.res.GuardedBackend(inner, mode="freivalds",
                                       max_retries=1, heal=False,
                                       policy="fail_closed")
        guard.attach_obs(pkg.obs(clock=lambda: 0.0))
        with pytest.raises(pkg.res.GuardError) as e:
            guard.matmul(a, b)
        return e.value

    t_err, j_err = _both(run)
    assert str(t_err) == str(j_err)
    assert [ev["name"] for ev in t_err.flight] == [
        ev["name"] for ev in j_err.flight] == [
        "guard_detect", "guard_retry", "guard_uncorrected"]
    assert_same(t_err.flight, j_err.flight, "flight recorder")


@pytest.mark.parametrize("mode", ["abft", "freivalds"])
def test_fail_open_returns_flagged_product(mode):
    a, b = _int_ops(8, 8, 8, seed=6)

    def run(pkg):
        inner, _ = _flaky_ideal(pkg, n_bad=10 ** 9)
        guard = pkg.res.GuardedBackend(inner, mode=mode, max_retries=1,
                                       heal=False, policy="fail_open")
        return guard.matmul(a, b)

    (t_out, t_tel), (j_out, j_tel) = _both(run)
    _same_tel(t_tel, j_tel)
    assert np.array_equal(t_out.numpy(), _np(j_out))
    if mode == "freivalds":      # honest telemetry about the escape
        assert t_tel.guard_uncorrected == 1
        assert not np.array_equal(
            t_out.numpy(), a.astype(np.float64) @ b.astype(np.float64))
    else:                        # one element: located and corrected
        assert t_tel.guard_corrected == 1 and t_tel.guard_uncorrected == 0


def test_mode_off_is_transparent():
    a, b = _int_ops(8, 8, 8, seed=7)

    def run(pkg):
        return _crashed_guard(pkg, mode="off").matmul(a, b)

    (t_out, t_tel), (j_out, j_tel) = _both(run)
    _same_tel(t_tel, j_tel)
    assert t_tel.guard_checks == 0 and t_tel.guard_detected == 0
    assert np.array_equal(t_out.numpy(), _np(j_out))
    assert not np.array_equal(t_out.numpy(),
                              a.astype(np.float64) @ b.astype(np.float64))


# ---- wiring -----------------------------------------------------------------


def test_constructor_validation_and_registry():
    for kw in ({"mode": "checksum"}, {"policy": "retry"},
               {"max_retries": -1}, {"probes": 0}):
        with pytest.raises(ValueError):
            tres.GuardedBackend(tbackend.IdealBackend(device="cpu"), **kw)
    be = tbackend.get_backend("guarded", device="cpu")
    jbe = jbackend.get_backend("guarded")
    assert isinstance(be, tres.GuardedBackend)
    assert be.is_guarded and not be.is_ideal
    assert be.name == jbe.name == "guarded[emulated]"
    assert be.device.type == "cpu" and be.inner.device.type == "cpu"
    assert_same(be.summary(), jbe.summary(), "summary")
    assert be.summary()["mode"] == "abft"
    ref = tbackend.get_backend("guarded", inner="reference", device="cpu")
    assert ref.name == "guarded[reference]"
    with pytest.raises(AttributeError):
        ref.accel                        # no live device behind reference


def test_summary_surfaces_inner_energy_accounting():
    a, b = _int_ops(8, 8, 8, seed=8)

    def run(pkg):
        guard = pkg.res.GuardedBackend(
            pkg.be.EmulatedBackend.nominal(**pkg.kw))
        guard.matmul(a, b)
        guard.add_tokens(1)
        return guard.summary()

    t, j = _both(run)
    assert_same(t, j, "summary")
    assert t["inner"]["backend"] == "emulated"
    assert t["energy_per_token_j"] is not None and t["energy_per_token_j"] > 0


@pytest.mark.parametrize("precision", [None, "f32", "int8"])
@pytest.mark.parametrize("name", ["reference", "emulated"])
def test_guarded_clean_products_equal_unguarded(name, precision):
    """At nominal rails the guard verifies and hands the inner product on:
    the same bits as the unguarded backend, one check a call, on real-valued
    operands too."""
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=(12, 40)), rng.normal(size=(40, 20))
    a, b = a.astype(np.float32), b.astype(np.float32)
    plain = tbackend.get_backend(name, device="cpu")
    guard = tres.GuardedBackend(tbackend.get_backend(name, device="cpu"))
    out, tel = guard.matmul(a, b, precision=precision)
    want, wtel = plain.matmul(a, b, precision=precision)
    assert torch.equal(out, want)
    assert (tel.guard_checks, tel.guard_detected, tel.calls) == (1, 0, 1)
    assert tel.macs == wtel.macs
    # float64 products are exact to 1e-16; the reference backend's float32
    # sums leave a few percent of tol = 1e-6 at these shapes
    assert 0.0 <= guard.max_clean_ratio < (0.25 if name == "reference"
                                           else 1e-6)


# ---- the chaos scripts on a guarded engine ----------------------------------


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


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 64, size=int(rng.integers(2, 5))).tolist()
            for _ in range(n)]


def _guarded_engine(pkg, cfg, params, session=None, corruption="bitflip"):
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import ServeEngine
    kw = {}
    if session is not None:
        inner = pkg.be.EmulatedBackend(session.accel)
        kw["hwloop"] = session
    else:
        inner = pkg.be.EmulatedBackend.nominal(corruption=corruption,
                                               **pkg.kw)
    guard = pkg.res.GuardedBackend(inner, mode="abft", policy="fail_closed")
    kw["obs"] = pkg.obs(recorder_capacity=128)
    if pkg is TORCH:
        eng = ServeEngine(cfg, params, slots=2, max_len=32, backend=guard,
                          device="cpu", **kw)
    else:
        eng = JServeEngine(cfg, params, slots=2, max_len=32, backend=guard,
                           **kw)
    return eng, guard


def _drain_scripted(eng, script):
    steps = 0
    while not eng.scheduler.drained() and steps < 2000:
        script(steps, eng)
        eng.step()
        steps += 1
    return eng.run_until_drained(max_steps=2000)


def _chaos(pkg, dense, scenario):
    from repro.serve import Request as JRequest
    from repro_torch.serve import Request
    jcfg, jparams, tcfg, tparams = dense
    cfg, params = (tcfg, tparams) if pkg is TORCH else (jcfg, jparams)
    session = None
    if scenario == "silent_burst":
        prompts, bursts = _prompts(3, 0), (1, 4)
        eng, guard = _guarded_engine(pkg, cfg, params)
    else:
        import repro.flow as jflow
        import repro.hwloop as jhw
        import repro_torch.flow as tflow
        import repro_torch.hwloop as thw
        flow, hw = (tflow, thw) if pkg is TORCH else (jflow, jhw)
        session = hw.HwLoopSession(flow.FlowConfig(**CFG_KW), probe_rows=8,
                                   rail_margin=0.02, patience=5, **pkg.kw)
        prompts, bursts = _prompts(3, 1), (2,)
        eng, guard = _guarded_engine(pkg, cfg, params, session=session)
    req_cls = Request if pkg is TORCH else JRequest
    reqs = [req_cls(uid=i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    accel = guard.accel

    def script(step, _eng):
        if step in bursts:                       # rail collapse
            accel.set_rails(np.full(accel.n_partitions, tres.V_CRASH))

    stats = _drain_scripted(eng, script)
    return types.SimpleNamespace(
        tokens=[list(r.out_tokens) for r in reqs],
        status=[r.status for r in reqs], tel=guard.total.to_dict(),
        events=stats.guard_step_events, rails=np.asarray(accel.rails).copy(),
        recal=None if session is None else session.recalibrations)


def _ideal_tokens(dense, prompts):
    """The port's own unguarded greedy decode of the workload (the bit-exact
    truth the guard must restore)."""
    from repro_torch.serve import Request, ServeEngine
    *_, tcfg, tparams = dense
    eng = ServeEngine(tcfg, tparams, slots=2, max_len=32, device="cpu")
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [list(r.out_tokens) for r in reqs]


#: guard counters the two packages must agree on; the MACs, silent count and
#: energy of a collapse depend on which GEMM of the step runs first, and the
#: JAX package's jitted step issues its callbacks in XLA's order (its first
#: decode GEMM here is a (128, 64) projection, the port's the (128, 128) one)
GUARD_KEYS = ("calls", "flags", "replays", "guard_checks", "guard_detected",
              "guard_corrected", "guard_retries", "guard_heals",
              "guard_uncorrected")


@pytest.mark.parametrize("scenario", ["silent_burst", "watchdog_delay"])
def test_chaos_script_on_a_guarded_engine_as_the_reference(dense, scenario):
    from test_torch_serve import BF16_TOL, _jax_logits_alone
    from repro.models import model_api as j_model_api
    t, j = _both(lambda pkg: _chaos(pkg, dense, scenario))
    assert t.status == j.status == ["completed"] * 3
    # every stream restored bit for bit: the port's own unguarded decode
    prompts = _prompts(3, 0 if scenario == "silent_burst" else 1)
    assert t.tokens == _ideal_tokens(dense, prompts)
    # and the reference's streams up to ties of the two stacks' bf16 noise
    jcfg, jparams = dense[:2]
    japi = j_model_api(jcfg)
    for p, got, want in zip(prompts, t.tokens, j.tokens):
        if got == want:
            continue
        # where they part, both tokens lie among the reference model's tied
        # largest logits (its batched and alone decodes may pick either)
        i = next(k for k, (g, w) in enumerate(zip(got, want)) if g != w)
        lg = np.asarray(_jax_logits_alone(japi, jparams, p, want[:i], 32),
                        np.float32)
        tied = lg >= lg.max() - 2 * BF16_TOL * np.abs(lg).max()
        assert tied[got[i]] and tied[want[i]], (scenario, p, got, want)
    for key in GUARD_KEYS:
        assert t.tel[key] == j.tel[key], key
    assert t.events == j.events
    assert np.array_equal(t.rails, j.rails)
    assert t.recal == j.recal
    assert t.tel["guard_detected"] >= 1 and t.tel["guard_heals"] >= 1
    assert t.tel["guard_uncorrected"] == 0 and t.tel["silent"] > 0
    assert float(t.rails.min()) > tres.V_CRASH
    if scenario == "silent_burst":
        assert len(t.events) >= 2                     # both bursts seen
    else:
        assert t.recal >= 1                           # healed THROUGH it


# ---- the checksum module ----------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transposed", [False, True])
def test_checksums_plain_against_the_references_gemvs(dtype, transposed):
    rng = np.random.default_rng(12)
    m, k, n = 5, 70, 33
    a = torch.as_tensor(rng.normal(size=(m, k))).to(dtype)
    b = torch.as_tensor(rng.normal(size=(n, k) if transposed
                                   else (k, n))).to(dtype)
    if transposed:
        b = b.T                                    # a (K, N) view
    x = torch.as_tensor(rng.integers(0, 2, size=(n, 3)) * 2.0 - 1.0)
    a64 = a.to(torch.float64).numpy()
    b64 = b.to(torch.float64).numpy()
    u = torch.as_tensor(np.stack([a64.sum(axis=0),
                                  np.abs(a64).sum(axis=0)]))
    v = torch.cat([torch.ones((n, 1), dtype=torch.float64), x], dim=1)
    bw, ub = abft_mod.abft_checksums(b, v, u, abs_rows=1)
    want = {"bsum": b64.sum(axis=1), "bx": b64 @ x.numpy(),
            "babs": np.abs(b64).sum(axis=1), "col_ref": a64.sum(axis=0) @ b64,
            "col_abs": np.abs(a64).sum(axis=0) @ np.abs(b64)}
    got = {"bsum": bw[:, 0], "bx": bw[:, 1:4], "babs": bw[:, 4],
           "col_ref": ub[0], "col_abs": ub[1]}
    scale = {"bsum": np.abs(b64).sum(axis=1), "bx": np.abs(b64).sum(axis=1),
             "babs": np.abs(b64).sum(axis=1),
             "col_ref": want["col_abs"], "col_abs": want["col_abs"]}
    assert tuple(bw.shape) == (k, 5) and tuple(ub.shape) == (2, n)
    for key, w in want.items():
        g = got[key].numpy()
        s = scale[key] if g.ndim == 1 else scale[key][:, None]
        assert g.dtype == np.float64 and g.shape == w.shape, key
        assert np.all(np.abs(g - w) <= TOL_CHECKSUM * s), key
    assert abft_mod.abft_checksums.launches == 0      # the CPU took no kernel


def test_checksums_validate_their_vectors():
    b = torch.zeros(4, 6)
    v = torch.zeros(6, 1, dtype=torch.float64)
    u = torch.zeros(2, 4, dtype=torch.float64)
    abft_mod.abft_checksums(b, v, u, abs_rows=1)
    for args in ((b, torch.zeros(5, 1, dtype=torch.float64), u, 0),
                 (b, v, torch.zeros(2, 4), 0),
                 (b, v, torch.zeros(5, 4, dtype=torch.float64), 0),
                 (b, v, u, 3), (b[0], v, u, 0)):
        with pytest.raises(ValueError):
            abft_mod.abft_checksums(*args)


@pytest.mark.parametrize("shape", [(3072, 5120), (3072, 200192),
                                   (8192, 3072), (200, 20), (7, 1000)])
def test_launch_plan_fills_the_card_and_covers_the_operand(shape):
    r, c = shape
    plan = abft_mod.launch_plan(r, c, torch.bfloat16)
    assert abft_mod.MIN_ROWS <= plan.rows <= abft_mod.MAX_ROWS
    assert plan.rows % abft_mod.CHUNK_ROWS == 0
    assert plan.n_cb * plan.strip >= c
    assert plan.n_rb * plan.rows >= r and plan.n_rb <= 65535
    blocks = plan.n_cb * plan.n_rb
    assert blocks <= abft_mod.TARGET_BLOCKS or (
        plan.rows in (abft_mod.MIN_ROWS, abft_mod.MAX_ROWS)
        or plan.n_cb > abft_mod.TARGET_BLOCKS)
    # the partial sums stay a small share of the operand's bytes
    pr, pc = plan.partial_doubles(2, 2)
    if r * c >= 1 << 24:
        assert 8 * (pr + pc) < 0.2 * 2 * r * c


@pytest.mark.parametrize("layout", ["row-major", "transposed", "strided"])
@pytest.mark.parametrize("n_probe", [0, 1, 5])
def test_kernel_route_maps_its_vectors_as_the_plain_version(
        layout, n_probe, monkeypatch):
    """The wrapper's side of the kernel (which axis is X's, which vector
    goes to P or Q with which |.| bit, probe groups of three, where a's sums
    and the pack's pieces go) on CPU tensors, with each launch emulated in
    the kernel's order (``test_torch_abft_plan.emulated_launch``): equal to
    the plain version."""
    from test_torch_abft_plan import emulated_launch
    monkeypatch.setattr(abft_mod, "_launch", emulated_launch)
    monkeypatch.setattr(abft_mod.abft_checksums, "launches", 0)
    rng = np.random.default_rng(13 + n_probe)
    k, n = 300, 700
    if layout == "row-major":
        b = torch.as_tensor(rng.normal(size=(k, n)))
    elif layout == "transposed":
        b = torch.as_tensor(rng.normal(size=(n, k))).T
    else:
        b = torch.as_tensor(rng.normal(size=(k, 2 * n)))[:, ::2]
    b = b.to(torch.bfloat16)
    v = torch.as_tensor(rng.integers(0, 2, size=(n, n_probe)) * 2.0 - 1.0)
    u = torch.as_tensor(rng.normal(size=(1, k)))
    for uu, abs_rows in ((torch.cat([u, u.abs()]), 1), (u, 0), (u[:0], 0)):
        got = abft_mod._general_route(b, v, uu, abs_rows)
        want = abft_mod.abft_checksums_plain(b, v, uu, abs_rows)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert torch.allclose(g, w, rtol=1e-12, atol=1e-9)
    a = torch.as_tensor(rng.normal(size=(4, k))).to(torch.bfloat16)
    got = abft_mod._abft_route(b, a, 1e-6)
    want = abft_mod.abft_checksums_plain(b, a=a, tol=1e-6)
    assert got.shape == want.shape == (2, 4 + n)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-9)
    assert abft_mod.abft_checksums.launches == 3 * max(1, -(-n_probe // 3)) + 1
