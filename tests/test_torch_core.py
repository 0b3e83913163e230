"""The port's ``core`` against ``repro.core``, bit for bit, on the seeds of
``tests/core/``.

``repro_torch.core`` is the reference's numpy code carried over; these
tests hold every public function of it to the reference's result on the
same inputs: exact equality of arrays (dtype included), floats, strings and
dataclass fields.  No tolerance anywhere.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import clustering as jcl
from repro.core import clustering_ref as jcl_ref
from repro.core import constraints as jcons
from repro.core import power as jpower
from repro_torch.core import clustering as tcl
from repro_torch.core import clustering_ref as tcl_ref
from repro_torch.core import constraints as tcons
from repro_torch.core import power as tpower

TECHS = sorted(jcore.TECH_NODES)
ALGOS = ("kmeans", "hierarchical", "meanshift", "dbscan")
SEEDS = (2021, 2022, 2023)


def assert_same(x, y, where="value"):
    """Exact structural equality across the two packages (classes compare
    by name, since each package has its own)."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        assert isinstance(x, np.ndarray) and isinstance(y, np.ndarray), where
        assert x.dtype == y.dtype and x.shape == y.shape, where
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=where)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        assert type(x).__name__ == type(y).__name__, where
        for f in dataclasses.fields(x):
            assert_same(getattr(x, f.name), getattr(y, f.name),
                        f"{where}.{f.name}")
    elif isinstance(x, (list, tuple)):
        assert type(x) is type(y) and len(x) == len(y), where
        for i, (a, b) in enumerate(zip(x, y)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(x, dict):
        assert x.keys() == y.keys(), where
        for k in x:
            assert_same(x[k], y[k], f"{where}[{k!r}]")
    elif isinstance(x, float) and np.isnan(x):
        assert isinstance(y, float) and np.isnan(y), where
    else:
        assert type(x) is type(y) and x == y, (where, x, y)


def _pair(name, *args, **kw):
    """The same call in both packages' core."""
    return getattr(jcore, name)(*args, **kw), getattr(tcore, name)(*args, **kw)


def test_public_names_equal():
    assert sorted(jcore.__all__) == sorted(tcore.__all__)
    for name in jcore.__all__:
        if isinstance(getattr(jcore, name), (int, float, str, tuple)):
            assert_same(getattr(jcore, name), getattr(tcore, name), name)


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("n,seed", [(8, 2021), (16, 2021), (16, 7)])
def test_timing_model_slacks_and_reports(tech, n, seed):
    jt = jcore.TimingModel(n=n, tech=jcore.TECH_NODES[tech], seed=seed)
    tt = tcore.TimingModel(n=n, tech=tcore.TECH_NODES[tech], seed=seed)
    for attr in ("path_delays_ns", "mac_delay_ns", "min_slack_ns"):
        assert_same(getattr(jt, attr), getattr(tt, attr), attr)
    assert_same(jt.min_slack_flat(), tt.min_slack_flat(), "min_slack_flat")
    assert_same(jt.delays_at(0.9), tt.delays_at(0.9), "delays_at")
    assert_same(jt.fails_at(0.8), tt.fails_at(0.8), "fails_at")
    assert_same(jt.min_safe_voltage(), tt.min_safe_voltage(), "v_safe")
    assert jcore.render_report_table(jt.report(20)) == \
        tcore.render_report_table(tt.report(20))
    assert_same(jt.report(20), tt.report(20), "report")
    for part in (True, False):
        assert_same(jt.implementation_report(20, partitioned=part),
                    tt.implementation_report(20, partitioned=part))
    for v in (1.0, 0.9, np.array([0.8, 0.95])):
        assert_same(jcore.delay_scale(jcore.TECH_NODES[tech], v),
                    tcore.delay_scale(tcore.TECH_NODES[tech], v), "scale")


def _slack(n, seed):
    return jcore.TimingModel(n=n, seed=seed).min_slack_flat()


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("impl", ["clustering", "clustering_ref"])
@pytest.mark.parametrize("n,seed", [(8, s) for s in SEEDS] + [(16, 2021)])
def test_clustering_labels(algo, impl, n, seed):
    x = _slack(n, seed)
    jmod, tmod = (jcl, tcl) if impl == "clustering" else (jcl_ref, tcl_ref)
    kw = {"kmeans": dict(k=4, seed=seed), "hierarchical": dict(n_clusters=4),
          "meanshift": dict(bandwidth=0.4),
          "dbscan": dict(eps=(x.max() - x.min()) / 12, min_pts=8)}[algo]
    assert_same(getattr(jmod, algo)(x, **kw), getattr(tmod, algo)(x, **kw),
                algo)
    assert_same(jmod.cluster(x, algo), tmod.cluster(x, algo), "cluster")


@pytest.mark.parametrize("impl", ["clustering", "clustering_ref"])
def test_clustering_helpers_and_dendrogram(impl):
    jmod, tmod = (jcl, tcl) if impl == "clustering" else (jcl_ref, tcl_ref)
    x = _slack(16, 2021)
    lab = jmod.dbscan(x, eps=(x.max() - x.min()) / 12, min_pts=8)
    assert_same(lab, tmod.dbscan(x, eps=(x.max() - x.min()) / 12, min_pts=8))
    for desc in (True, False):
        assert_same(jmod.relabel_by_feature_mean(x, lab, descending=desc),
                    tmod.relabel_by_feature_mean(x, lab, descending=desc))
    assert_same(jmod.attach_noise_to_nearest(x, lab),
                tmod.attach_noise_to_nearest(x, lab))
    assert_same(jmod.silhouette(x, lab), tmod.silhouette(x, lab))
    jd, td = jmod.hierarchical_dendrogram(x), tmod.hierarchical_dendrogram(x)
    for field in ("left", "right", "size", "height"):
        assert_same(getattr(jd, field), getattr(td, field), field)
    for k in (2, 3, 4, 7):
        assert_same(jd.cut(k), td.cut(k), f"cut({k})")
    rng = np.random.default_rng(3)
    mix = np.concatenate([rng.normal(c, 0.05, (30, 2)) for c in (0, 1, 2)])
    assert_same(jmod.kmeans(mix, 3, seed=1), tmod.kmeans(mix, 3, seed=1))
    assert_same(jmod.meanshift(mix, bandwidth=0.3),
                tmod.meanshift(mix, bandwidth=0.3))


@pytest.mark.parametrize("n", [8, 16])
def test_floorplans(n):
    x = _slack(n, 2021)
    lab = jcl.relabel_by_feature_mean(x, jcl.kmeans(x, 4, seed=0))
    jf, tf = _pair("grid_floorplan", lab, n)
    assert_same(jf, tf, "grid_floorplan")
    assert_same(jf.partition_of_mac(), tf.partition_of_mac())
    assert_same(jf.voltage_map(), tf.voltage_map())
    v = [0.96, 0.97, 0.98, 0.99]
    assert_same(jf.with_voltages(v), tf.with_voltages(v))
    assert [p.slice_range() for p in jf.partitions] == \
        [p.slice_range() for p in tf.partitions]
    assert_same(*_pair("quadrant_floorplan", n))
    assert_same(*_pair("partition_min_slack", lab, x))
    fp_j = jcore.quadrant_floorplan(n).with_voltages(v)
    fp_t = tcore.quadrant_floorplan(n).with_voltages(v)
    assert jcons.generate_xdc(fp_j, clock_ns=10.0) == \
        tcons.generate_xdc(fp_t, clock_ns=10.0)
    assert jcons.generate_sdc(fp_j) == tcons.generate_sdc(fp_t)
    assert jcons.mac_cell_name(5, n) == tcons.mac_cell_name(5, n)


@pytest.mark.parametrize("tech", TECHS)
def test_power_model(tech):
    assert_same(*_pair("fit_power_exponent", tech))
    assert_same(jpower.fit_power_exponent_ref(tech),
                tpower.fit_power_exponent_ref(tech))
    jm, tm = _pair("model_for", tech)
    assert_same(jm, tm, "PowerModel")
    v = np.array([0.96, 0.97, 0.98, 0.99])
    for n in (16, 64):
        assert_same(jm.baseline_mw(n), tm.baseline_mw(n))
        assert_same(jm.partitioned_mw(n, v), tm.partitioned_mw(n, v))
        assert_same(jm.reduction_pct(n, v, v_ref=1.0),
                    tm.reduction_pct(n, v, v_ref=1.0))
    assert_same(jm.energy_per_mac_pj(0.9), tm.energy_per_mac_pj(0.9))
    assert_same(jm.macs_energy_j(1e9, v), tm.macs_energy_j(1e9, v))
    assert_same(*_pair("paper_table2_flow", 16, tech))


def test_validate_against_table2_and_paper_table():
    assert_same(*_pair("validate_against_table2"))
    assert_same(jcore.PAPER_TABLE2, tcore.PAPER_TABLE2, "PAPER_TABLE2")


def test_razor_model():
    cfg_j = jcore.RazorConfig(clock_ns=10.0, t_del_ns=2.5, beta=0.25)
    cfg_t = tcore.RazorConfig(clock_ns=10.0, t_del_ns=2.5, beta=0.25)
    assert_same(cfg_j, cfg_t)
    arr = np.random.default_rng(0).uniform(0.1, 20.0, 4096)
    arr[:6] = [9.9, 10.0, 10.1, 12.5, 12.51, 99.0]
    assert_same(jcore.classify_arrival(arr, cfg_j),
                tcore.classify_arrival(arr, cfg_t))
    bits = np.random.default_rng(1).integers(0, 2 ** 16, (2, 64))
    assert_same(jcore.switching_activity(bits[0], bits[1]),
                tcore.switching_activity(bits[0], bits[1]))
    a = np.random.default_rng(2).normal(size=(24, 16))
    act_j, act_t = jcore.streamed_activity(a), tcore.streamed_activity(a)
    assert_same(act_j, act_t)
    d = np.random.default_rng(3).uniform(8, 12, (16, 16))
    assert_same(jcore.effective_arrival(d, act_j[0], cfg_j),
                tcore.effective_arrival(d, act_t[0], cfg_t))
    for delay in (9.0, 10.2, 10.5, 13.0):
        mj = jcore.RazorMac(delay_ns=delay, cfg=cfg_j)
        mt = tcore.RazorMac(delay_ns=delay, cfg=cfg_t)
        for activity in (0.0, 0.5, 1.0):
            assert_same(mj.cycle(1.5, -2.0, 0.25, activity),
                        mt.cycle(1.5, -2.0, 0.25, activity))
        assert_same(mj, mt)


def _sims(v, impl):
    out = []
    for core in (jcore, tcore):
        tm = core.TimingModel(n=16, tech=core.TECH_NODES["vtr-22nm"],
                              seed=2021)
        fp = core.quadrant_floorplan(16).with_voltages(v)
        out.append(core.SystolicSim(tm, fp, core.RazorConfig(), impl=impl))
    return out


@pytest.mark.parametrize("v", [1.0, 0.75, 0.64, 0.55])
@pytest.mark.parametrize("impl", ["vectorized", "reference"])
def test_systolic_sim_products_and_stats(v, impl):
    sj, st = _sims([v, v * 1.03, v * 0.97, v], impl)
    rng = np.random.default_rng(11)
    a, w = rng.normal(size=(48, 16)), rng.normal(size=(16, 16))
    cj, stats_j = sj.matmul(a, w)
    ct, stats_t = st.matmul(a, w)
    assert_same(cj, ct, "product")
    assert_same(stats_j, stats_t, "SimStats")
    part = sj.floorplan.partition_of_mac()
    assert_same(stats_j.partition_detected(part),
                stats_t.partition_detected(part))
    for seed in range(3):
        pv = np.array([v, v * 1.05, v * 0.95, v])
        assert_same(sj.trial_run(pv, seed=seed), st.trial_run(pv, seed=seed))


@pytest.mark.parametrize("mode", ["drop", "attenuate"])
def test_fast_fault_matmul(mode):
    rng = np.random.default_rng(4)
    a, w = rng.normal(size=(32, 16)), rng.normal(size=(16, 16))
    mask = rng.random((16, 16)) < 0.2
    assert_same(*_pair("fast_fault_matmul", a, w, mask, mode=mode))


@pytest.mark.parametrize("method", ["calibrate", "calibrate_bisect"])
def test_runtime_scheme_calibration(method):
    """Algorithm 2 on the simulator's trial runs, as the flow's stage drives
    it: same rails, convergence flags, history and trial count."""
    results = []
    for core in (jcore, tcore):
        node = core.TECH_NODES["vtr-22nm"]
        tm = core.TimingModel(n=16, tech=node, seed=2021)
        sim = core.SystolicSim(tm, core.quadrant_floorplan(16),
                               core.RazorConfig())
        scheme = core.RuntimeScheme(v_s=(node.v_min - node.v_crash) / 4,
                                    v_floor=node.v_crash,
                                    v_ceil=max(node.v_min, node.v_nom))
        trials = []

        def trial(v, sim=sim, trials=trials):
            trials.append(1)
            return sim.trial_run(v, seed=2021 + len(trials))

        v0 = core.static_voltage_scaling(node.v_min, node.v_crash, 4)
        res = getattr(scheme, method)(v0, trial, max_trials=24)
        results.append((np.asarray(res), np.asarray(res.converged),
                        list(scheme.history), len(trials)))
    assert_same(results[0], results[1])


@pytest.mark.parametrize("algo", ALGOS)
def test_run_flow_shim(algo):
    rj = jcore.run_flow(array_n=8, algo=algo, seed=2021, max_trials=8)
    rt = tcore.run_flow(array_n=8, algo=algo, seed=2021, max_trials=8)
    assert_same(rj, rt, "FlowReport")
    assert rj.summary() == rt.summary()
