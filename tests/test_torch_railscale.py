"""The port's ``railscale`` against ``repro.railscale``, on the CPU.

Every case of ``tests/railscale/`` runs in both packages: the same ladder
(``to_dict()`` and ``save_tables`` bytes) from the same ``FlowReport``, the
characterization on the CPU; the same policy decisions and clamp writes on a
seeded stream of signals; and on a starcoder2 smoke engine the same
autoscaler decisions, transitions, levels, rails, ``railscale_decision``
events and J/token, static as a no-op, and a watchdog heal pre-empting the
dwell.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

import repro.flow as jflow
import repro.hwloop as jhw
import repro.railscale as jrs
import repro_torch.flow as tflow
import repro_torch.hwloop as thw
import repro_torch.railscale as trs
from repro.obs import ObsBus as JObsBus
from repro_torch.obs import ObsBus
from test_torch_core import assert_same

CFG_KW = dict(array_n=8, tech="vtr-22nm", max_trials=8, seed=2021)

JAX = types.SimpleNamespace(rs=jrs, flow=jflow, hw=jhw, obs=JObsBus, kw={},
                            name="jax")
TORCH = types.SimpleNamespace(rs=trs, flow=tflow, hw=thw, obs=ObsBus,
                              kw={"device": "cpu"}, name="torch")
PKGS = [TORCH, JAX]


def _both(fn):
    return fn(TORCH), fn(JAX)


def _point(pkg, level, rails, **kw):
    base = dict(energy_per_token_j=1e-8, flag_rate=0.0, replay_rate=0.0,
                throughput_scale=1.0)
    base.update(kw)
    return pkg.rs.OperatingPoint(level=level, rails_v=list(rails), **base)


@pytest.fixture(scope="module")
def flows():
    """(config, report, store) of each package at the launcher's operating
    point."""
    out = {}
    for pkg in PKGS:
        store = pkg.flow.ArtifactStore()
        cfg = pkg.flow.FlowConfig(**CFG_KW)
        out[pkg.name] = (cfg, pkg.flow.run(cfg, store=store), store)
    return out


@pytest.fixture(scope="module")
def tables(flows):
    out = {}
    for pkg in PKGS:
        cfg, report, _ = flows[pkg.name]
        out[pkg.name] = pkg.rs.OperatingPointTable.characterize(
            report, cfg, n_levels=4, probe_steps=4, seed=cfg.seed, **pkg.kw)
    return out


def test_public_names_equal():
    assert sorted(trs.__all__) == sorted(jrs.__all__)
    assert sorted(trs.POLICIES) == sorted(jrs.POLICIES)
    assert trs.points.SCHEMA_VERSION == jrs.points.SCHEMA_VERSION


# ---- operating-point tables -------------------------------------------------


@pytest.mark.parametrize("case", ["gaps", "widths", "empty", "monotone"])
def test_table_rejects_what_the_reference_rejects(case):
    def build(pkg):
        p = lambda *a: _point(pkg, *a)      # noqa: E731
        pts = {"gaps": [p(0, [1.0]), p(2, [0.9])],
               "widths": [p(0, [1.0, 1.0]), p(1, [0.9])],
               "empty": [],
               "monotone": [p(0, [0.9, 0.9]), p(1, [1.0, 1.0])]}[case]
        with pytest.raises(ValueError) as e:
            pkg.rs.OperatingPointTable(pts)
        return str(e.value)

    t, j = _both(build)
    assert t == j


def test_floor_ceil_nearest():
    def run(pkg):
        t = pkg.rs.OperatingPointTable([
            _point(pkg, 0, [1.0, 1.0]), _point(pkg, 1, [0.9, 0.95]),
            _point(pkg, 2, [0.8, 0.9])])
        return (t.floor_v().tolist(), t.ceil_v().tolist(),
                [t.nearest_level(r) for r in
                 ([1.0, 1.0], [0.79, 0.91], [0.91, 0.94])])

    t, j = _both(run)
    assert t == j == ([0.8, 0.9], [1.0, 1.0], [0, 2, 1])


def test_characterize_gives_the_references_ladder(flows, tables, tmp_path):
    t, j = tables["torch"], tables["jax"]
    assert t.to_dict() == j.to_dict()
    trs.save_tables(tmp_path / "t.json", [t])
    jrs.save_tables(tmp_path / "j.json", [j])
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    # the reference's properties of the ladder
    fcfg, report, _ = flows["torch"]
    assert len(t) == 4 and t.n_partitions == len(report.runtime_v)
    np.testing.assert_allclose(t.rails(0), fcfg.node.v_nom)
    np.testing.assert_allclose(
        t.rails(3), np.asarray(report.runtime_v) + 0.02, atol=1e-12)
    energies = [p.energy_per_token_j for p in t.points]
    assert energies[-1] < energies[0] and all(e > 0 for e in energies)
    assert t.meta["tech"] == fcfg.tech and t.meta["array_n"] == fcfg.array_n


@pytest.mark.parametrize("n_levels,probe_steps,seed", [(2, 3, 7), (5, 2, 0)])
def test_characterize_other_ladders_as_the_reference(flows, n_levels,
                                                     probe_steps, seed):
    def run(pkg):
        cfg, report, _ = flows[pkg.name]
        return pkg.rs.OperatingPointTable.characterize(
            report, cfg, n_levels=n_levels, probe_steps=probe_steps,
            seed=seed, **pkg.kw).to_dict()

    t, j = _both(run)
    assert t == j


def test_characterize_is_deterministic(flows, tables):
    fcfg, report, _ = flows["torch"]
    again = trs.OperatingPointTable.characterize(
        report, fcfg, n_levels=4, probe_steps=4, seed=fcfg.seed,
        device="cpu")
    assert again.to_dict() == tables["torch"].to_dict()


def test_characterize_requires_calibrated_report(flows):
    def run(pkg):
        fcfg, report, _ = flows[pkg.name]
        uncal = dataclasses.replace(report, runtime_v=None)
        with pytest.raises(ValueError, match="runtime_v") as e:
            pkg.rs.OperatingPointTable.characterize(uncal, fcfg, **pkg.kw)
        with pytest.raises(ValueError, match="n_levels"):
            pkg.rs.OperatingPointTable.characterize(report, fcfg, n_levels=0,
                                                    **pkg.kw)
        return str(e.value)

    t, j = _both(run)
    assert t == j


def test_json_round_trip_and_cross_load(tmp_path, tables):
    t, j = tables["torch"], tables["jax"]
    t.save(tmp_path / "points.json")
    assert trs.OperatingPointTable.load(tmp_path / "points.json").to_dict() \
        == t.to_dict()
    # each package loads the other's file
    assert jrs.OperatingPointTable.load(tmp_path / "points.json").to_dict() \
        == j.to_dict()


def test_multi_table_load_selectors(tmp_path):
    def run(pkg):
        a = pkg.rs.OperatingPointTable(
            [_point(pkg, 0, [1.0]), _point(pkg, 1, [0.9])],
            meta={"tech": "vtr-22nm", "array_n": 8})
        b = pkg.rs.OperatingPointTable(
            [_point(pkg, 0, [1.0]), _point(pkg, 1, [0.85])],
            meta={"tech": "vivado-28nm", "array_n": 8})
        path = tmp_path / f"multi_{pkg.name}.json"
        pkg.rs.save_tables(path, [a, b])
        assert len(pkg.rs.load_tables(path)) == 2
        got = pkg.rs.OperatingPointTable.load(path, tech="vivado-28nm")
        assert got.to_dict() == b.to_dict()
        errs = []
        for sel in ({"tech": "nope"}, {"array_n": 8}):
            with pytest.raises(KeyError) as e:
                pkg.rs.OperatingPointTable.load(path, **sel)
            errs.append(str(e.value))
        return path.read_bytes(), errs

    t, j = _both(run)
    assert t == j


def test_load_rejects_unknown_version(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"version": 99, "tables": []}')

    def run(pkg):
        with pytest.raises(ValueError, match="version") as e:
            pkg.rs.load_tables(path)
        return str(e.value)

    t, j = _both(run)
    assert t == j


# ---- policies ---------------------------------------------------------------


class FakeTable:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def _signals(pkg, n, seed):
    """A seeded stream of decision windows: idle, loaded, flagged and
    SLO-pressured windows mixed."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(n):
        head = None if rng.random() < 0.3 else float(rng.uniform(-0.5, 1.0))
        out.append(pkg.rs.RailSignals(
            step=step, queue_depth=float(rng.integers(0, 6)),
            active_frac=float(rng.uniform(0, 1.2)),
            flag_rate=float(rng.choice([0.0, 0.0, 0.1, 0.3])),
            replay_rate=float(rng.uniform(0, 0.01)),
            energy_per_token_j=None, ttft_headroom=head))
    return out


@pytest.mark.parametrize("policy,kw", [
    ("static", {}), ("threshold", {}),
    ("threshold", {"queue_low": 1.0, "queue_high": 3.0, "flag_high": 0.2}),
    ("pid", {}),
    ("pid", {"kp": 0.5, "ki": 0.05, "setpoint": 1.0, "queue_ref": 8.0})])
def test_policy_decisions_on_a_seeded_signal_stream(policy, kw):
    def run(pkg):
        p = pkg.rs.get_policy(policy, **kw)
        level, levels = 0, []
        for s in _signals(pkg, 200, seed=len(kw) + len(policy)):
            level = int(p.decide(s, level, FakeTable(4)))
            levels.append(level)
        return levels

    t, j = _both(run)
    assert t == j
    assert len(set(t)) > 1 or policy == "static"


def test_policy_rules_as_the_reference():
    def run(pkg):
        sig = lambda **k: pkg.rs.RailSignals(**{   # noqa: E731
            "step": 0, "queue_depth": 0.0, "active_frac": 0.0,
            "flag_rate": 0.0, "replay_rate": 0.0,
            "energy_per_token_j": None, "ttft_headroom": None, **k})
        th, pid = pkg.rs.ThresholdPolicy(), pkg.rs.PIDPolicy()
        out = [th.decide(sig(queue_depth=5.0), 2, FakeTable(4)),
               th.decide(sig(flag_rate=0.5), 2, FakeTable(4)),
               th.decide(sig(ttft_headroom=0.1), 2, FakeTable(4)),
               th.decide(sig(), 2, FakeTable(4)),
               th.decide(sig(ttft_headroom=0.3), 2, FakeTable(4)),
               th.decide(sig(active_frac=1.5), 2, FakeTable(4)),
               pid.decide(sig(), 0, FakeTable(4)),
               pid.decide(sig(queue_depth=40.0), 3, FakeTable(4))]
        for _ in range(50):
            pid.decide(sig(queue_depth=40.0), 0, FakeTable(4))
        out.append(pid._integral)
        with pytest.raises(ValueError):
            pkg.rs.ThresholdPolicy(queue_low=2.0, queue_high=1.0)
        with pytest.raises(KeyError):
            pkg.rs.get_policy("warp-drive")
        with pytest.raises(TypeError):
            pkg.rs.get_policy(pkg.rs.StaticPolicy(), kp=1.0)
        with pytest.raises(TypeError):
            pkg.rs.get_policy(object())
        inst = pkg.rs.StaticPolicy()
        assert pkg.rs.get_policy(inst) is inst
        return out

    t, j = _both(run)
    assert t == j
    assert t[:3] == [1, 1, 1] and t[3] == 3 and t[4:6] == [2, 2]
    assert t[6] == 3 and t[7] == 0 and t[8] == 4.0


# ---- the guardband clamp ----------------------------------------------------


class FakeSession:
    """Duck-typed rail target: records every per-partition write."""

    def __init__(self, rails):
        self._rails = np.asarray(rails, dtype=np.float64)
        self.writes = []

    @property
    def rails(self):
        return self._rails

    def set_partition_voltage(self, p, v):
        self._rails[int(p)] = float(v)
        self.writes.append((int(p), float(v)))


def test_clamp_validation_as_the_reference():
    def run(pkg):
        msgs = []
        for args, kw in ((([0.8], [1.0, 1.0]), {}), (([np.nan], [1.0]), {}),
                         (([1.1], [1.0]), {}),
                         (([0.8], [1.0]), {"max_step_v": 0.0})):
            with pytest.raises(ValueError) as e:
                pkg.rs.GuardbandClamp(*args, **kw)
            msgs.append(str(e.value))
        c = pkg.rs.GuardbandClamp([0.8, 0.8], [1.0, 1.0])
        for bad in ([np.nan, 0.9], [0.9]):
            with pytest.raises(ValueError) as e:
                c.clamp(bad)
            msgs.append(str(e.value))
        return msgs

    t, j = _both(run)
    assert t == j


def test_clamp_writes_on_a_seeded_target_stream():
    """Targets in and out of the envelope, urgent and not, across dwell
    windows, a snap and a heal: the same writes and returns."""
    rng = np.random.default_rng(21)
    targets = rng.uniform(0.7, 1.1, size=(60, 2))
    urgent = rng.random(60) < 0.3

    def run(pkg):
        c = pkg.rs.GuardbandClamp([0.8, 0.8], [1.0, 1.0], max_step_v=0.05,
                                  dwell_steps=4)
        s = FakeSession([1.0, 1.0])
        out = [c.clamp([0.5, 1.5]).tolist(), c.snap(s, [0.7, 0.95]).tolist()]
        for step, (tg, u) in enumerate(zip(targets, urgent)):
            if step == 30:
                c.notify_heal(step)
            got = c.apply(s, tg, step, urgent=bool(u))
            out.append(None if got is None else got.tolist())
            out.append(c.dwell_active(step))
        return out, s.writes

    t, j = _both(run)
    assert t == j
    assert any(x is None for x in t[0]) and len(t[1]) > 10


# ---- the autoscaler on a serving engine --------------------------------------


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
    return {"jax": (jcfg, jparams), "torch": (tcfg, tparams)}


def _session(pkg, store, **kw):
    return pkg.hw.HwLoopSession(pkg.flow.FlowConfig(**CFG_KW), probe_rows=8,
                                rail_margin=0.02, store=store, **pkg.kw,
                                **kw)


def _drain(pkg, dense, session, auto, n_reqs=2, new_tokens=8):
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import Request, ServeEngine
    cfg, params = dense[pkg.name]
    if pkg is TORCH:
        eng = ServeEngine(cfg, params, slots=2, max_len=32, hwloop=session,
                          autoscaler=auto, device="cpu")
        req_cls = Request
    else:
        eng = JServeEngine(cfg, params, slots=2, max_len=32, hwloop=session,
                           autoscaler=auto)
        req_cls = JRequest
    reqs = [req_cls(uid=i, prompt=[3 + i, 4 + i], max_new_tokens=new_tokens)
            for i in range(n_reqs)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    return eng, stats, [list(r.out_tokens) for r in reqs]


class FakeEngine:
    """Just enough engine surface for Autoscaler.attach in unit tests."""

    def __init__(self, session, obs):
        self.hwloop = session
        self.obs = obs


def _events(eng, name):
    return [{k: v for k, v in e.items() if k != "t"}
            for e in eng.obs.recorder.to_list() if e["name"] == name]


def test_constructor_and_attach_validation(flows, tables):
    def run(pkg):
        _, _, store = flows[pkg.name]
        table = tables[pkg.name]
        msgs = []
        for args, kw, exc in (((table,), {"decide_every": 0}, ValueError),
                              ((table, "warp-drive"), {}, KeyError)):
            with pytest.raises(exc) as e:
                pkg.rs.Autoscaler(*args, **kw)
            msgs.append(str(e.value))
        with pytest.raises(ValueError, match="hwloop") as e:
            pkg.rs.Autoscaler(table, "threshold").attach(
                FakeEngine(None, pkg.obs()))
        msgs.append(str(e.value))
        auto = pkg.rs.Autoscaler(table, "threshold", start_level=0)
        eng = FakeEngine(_session(pkg, store), pkg.obs())
        auto.attach(eng)
        with pytest.raises(RuntimeError, match="already attached"):
            auto.attach(eng)
        narrow = pkg.rs.OperatingPointTable([
            _point(pkg, 0, [1.0, 1.0]), _point(pkg, 1, [0.9, 0.9])])
        with pytest.raises(ValueError, match="partitions") as e:
            pkg.rs.Autoscaler(narrow, "threshold").attach(
                FakeEngine(_session(pkg, store), pkg.obs()))
        msgs.append(str(e.value))
        return msgs, auto.summary()

    t, j = _both(run)
    assert t == j


def test_threshold_descends_and_saves_energy_as_the_reference(dense, flows,
                                                              tables):
    def run(pkg):
        _, _, store = flows[pkg.name]
        table = tables[pkg.name]
        nominal = table.rails(0)
        s_static = _session(pkg, store)
        for p in range(s_static.n_partitions):
            s_static.set_partition_voltage(p, float(nominal[p]))
        _, st_static, toks_static = _drain(pkg, dense, s_static, None)
        s_auto = _session(pkg, store)
        auto = pkg.rs.Autoscaler(table, "threshold", decide_every=1,
                                 dwell_steps=1, start_level=0)
        eng, st_auto, toks_auto = _drain(pkg, dense, s_auto, auto)
        return types.SimpleNamespace(
            rs=st_auto.railscale, toks=toks_auto, toks_static=toks_static,
            e_auto=st_auto.hwloop["energy_per_token_j"],
            e_static=st_static.hwloop["energy_per_token_j"],
            hw=st_auto.hwloop, level_gauge=eng.obs.registry.gauge(
                "railscale_level").value(),
            events=_events(eng, "railscale_decision"))

    t, j = _both(run)
    assert_same(t.rs, j.rs, "railscale summary")
    assert t.toks == j.toks and t.toks_static == j.toks_static
    assert t.e_auto == j.e_auto and t.e_static == j.e_static
    assert_same(t.hw, j.hw, "hwloop summary")
    assert t.events == j.events
    # the reference's own claims, on the port
    assert t.rs["policy"] == "threshold" and t.rs["transitions"]["down"] > 0
    assert t.rs["level"] > 0 and t.level_gauge == t.rs["level"]
    assert t.e_auto < t.e_static
    assert t.toks == t.toks_static
    assert len(t.events) == t.rs["decisions"]
    assert {e["action"] for e in t.events} & {"down", "hold"}


def test_static_policy_is_a_bit_compatible_noop(dense, flows, tables):
    def run(pkg):
        _, _, store = flows[pkg.name]
        table = tables[pkg.name]
        s_plain = _session(pkg, store)
        rails_before = s_plain.rails.copy()
        _, _, toks_plain = _drain(pkg, dense, s_plain, None)
        s_static = _session(pkg, store)
        auto = pkg.rs.Autoscaler(table, "static", start_level=0)
        _, st_auto, toks_auto = _drain(pkg, dense, s_static, auto)
        np.testing.assert_array_equal(s_static.rails, rails_before)
        assert toks_auto == toks_plain
        return st_auto.railscale, table.nearest_level(rails_before)

    (t_rs, t_lv), (j_rs, j_lv) = _both(run)
    assert_same(t_rs, j_rs, "railscale summary")
    assert t_rs["transitions"] == {"up": 0, "down": 0}
    assert t_rs["decisions"] == 0 and t_rs["level"] == t_lv == j_lv


def test_heal_preempts_dwell_and_holdoff_blocks_reundervolt(flows, tables):
    def run(pkg):
        _, _, store = flows[pkg.name]
        table = tables[pkg.name]
        session = _session(pkg, store, patience=2)
        auto = pkg.rs.Autoscaler(table, "threshold", decide_every=1,
                                 dwell_steps=4, heal_holdoff_steps=10,
                                 start_level=0)
        auto.attach(FakeEngine(session, pkg.obs(clock=lambda: 0.0)))
        trace = [session.rails.tolist()]
        ones = np.ones(session.n_partitions, dtype=bool)
        for _ in range(8):
            if session.observe_flags(ones):
                break
        assert session.recalibrations == 1
        auto.on_decode_step()
        trace.append((auto.level, auto._heal_preemptions,
                      auto.clamp._last_transition_step, auto._steps))
        auto._g_queue.set(5.0)
        auto.on_decode_step()                       # urgent boost
        trace.append((auto.level, dict(auto._transitions),
                      session.rails.tolist()))
        auto._g_queue.set(0.0)
        auto.on_decode_step()                       # holdoff blocks descent
        trace.append((auto.level, session.rails.tolist()))
        for _ in range(20):
            auto.on_decode_step()
            if auto.level == len(table) - 1:
                break
        trace.append((auto.level, dict(auto._transitions),
                      auto._heal_preemptions, auto.summary()))
        return trace, auto._obs.recorder.to_list()

    (t_trace, t_ev), (j_trace, j_ev) = _both(run)
    assert_same(t_trace, j_trace, "trace")
    assert_same(t_ev, j_ev, "events")
    deepest = len(tables["torch"]) - 1
    assert t_trace[1][:2] == (deepest, 1) and t_trace[1][2] == t_trace[1][3]
    assert t_trace[2][0] == deepest - 1 and t_trace[2][1]["up"] == 1
    assert t_trace[3][0] == deepest - 1
    assert [e["name"] for e in t_ev][:1] == ["railscale_heal_preempt"]
    assert t_trace[4][0] == deepest and t_trace[4][1]["down"] >= 1
    assert t_trace[4][2] == 1
