"""The port's ``flow`` against ``repro.flow``: reports, sweeps, config
validation, the opt-in ``hwloop`` stage and the CLI, bit for bit, with the
CLI's ``--points-out`` file byte for byte."""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.flow as jflow
import repro_torch.flow as tflow
from repro.core import TECH_NODES
from repro.flow.__main__ import main as jmain
from repro_torch.flow.__main__ import main as tmain
from test_torch_core import assert_same

TECHS = sorted(TECH_NODES)
ALGOS = jflow.KNOWN_ALGOS
SRC = Path(__file__).resolve().parent.parent / "src"


def test_public_names_and_stage_registry_equal():
    assert sorted(jflow.__all__) == sorted(tflow.__all__)
    assert jflow.DEFAULT_STAGE_NAMES == tflow.DEFAULT_STAGE_NAMES
    assert sorted(jflow.STAGE_REGISTRY) == sorted(tflow.STAGE_REGISTRY)
    for name, cls in jflow.STAGE_REGISTRY.items():
        t = tflow.STAGE_REGISTRY[name]
        assert (cls.requires, cls.provides, cls.config_keys,
                cls.content_cache) == (t.requires, t.provides, t.config_keys,
                                       t.content_cache), name
    assert jflow.ROW_COLUMNS == tflow.ROW_COLUMNS
    assert jflow.HWLOOP_COLUMNS == tflow.HWLOOP_COLUMNS


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("tech", TECHS)
def test_flow_report_grid(tech, algo):
    kw = dict(array_n=8, tech=tech, algo=algo, max_trials=8)
    rj = jflow.run(jflow.FlowConfig(**kw))
    rt = tflow.run(tflow.FlowConfig(**kw))
    assert_same(rj, rt, "FlowReport")
    assert rj.summary() == rt.summary()


def test_default_flow_gives_the_papers_numbers():
    rj, rt = jflow.run(), tflow.run()
    assert_same(rj, rt, "FlowReport")
    assert "static 6.53% runtime 12.88%" in rt.summary()
    assert rt.n_partitions == 4 and round(rt.baseline_mw) == 408


@pytest.mark.parametrize("kw", [
    dict(impl="reference"), dict(calibration_method="bisect"),
    dict(calibrate=False), dict(flag_reduce="and", n_clusters=3),
    dict(algo="meanshift", algo_params={"bandwidth": 0.3}),
    dict(v_min=0.95, v_crash=0.7, freq_mhz=200.0, activity=0.25)],
    ids=["reference", "bisect", "no-calibrate", "and-3", "meanshift-bw",
         "rails"])
def test_flow_report_options(kw):
    base = dict(array_n=8, max_trials=8)
    assert_same(jflow.run(jflow.FlowConfig(**base, **kw)),
                tflow.run(tflow.FlowConfig(**base, **kw)), "FlowReport")


def test_sweep_rows_table_and_cache_equal():
    grid = {"tech": ["vivado-28nm", "vtr-22nm"], "algo": ["kmeans", "dbscan"],
            "array_n": [8]}
    sj = jflow.sweep(grid, jflow.FlowConfig(max_trials=8))
    st = tflow.sweep(grid, tflow.FlowConfig(max_trials=8))
    assert_same(sj.rows(), st.rows(), "rows")
    assert sj.table() == st.table()
    assert sj.best() == st.best()
    assert sj.timing_stage_runs() == st.timing_stage_runs()
    assert sj.store.summary() == st.store.summary()
    for a, b in zip(sj.reports, st.reports):
        assert_same(a, b, "FlowReport")


def test_pipeline_composition_and_caching_equal():
    out = []
    for flow in (jflow, tflow):
        store = flow.ArtifactStore()
        pipe = flow.Pipeline().without("constraints")
        cfg = flow.FlowConfig(array_n=8, max_trials=8)
        art = pipe.run(cfg, store=store)
        again = pipe.run(cfg.replace(algo="kmeans"), store=store)
        upto = flow.Pipeline().run(cfg, upto="cluster")
        out.append((art.runtime_v, art.static_v, again.labels,
                    sorted(art.keys()), sorted(upto.keys()), store.summary(),
                    flow.FlowConfig.from_json(cfg.to_json()).to_dict()))
    assert_same(out[0], out[1])


@pytest.mark.parametrize("bad", [
    dict(tech="nope"), dict(algo="nope"), dict(array_n=0),
    dict(n_clusters=0), dict(clock_ns=0), dict(max_trials=-1),
    dict(flag_reduce="xor"), dict(impl="fast"), dict(activity=0),
    dict(hwloop_steps=0), dict(backend="nope"), dict(hwloop_corruption="nope"),
    dict(v_min=0.5, v_crash=0.7)])
def test_config_validation_equal(bad):
    with pytest.raises(ValueError) as ej:
        jflow.FlowConfig(**bad)
    with pytest.raises(ValueError) as et:
        tflow.FlowConfig(**bad)
    assert str(ej.value).split(";")[0] == str(et.value).split(";")[0]


def test_config_defaults_and_accepted_values_equal():
    assert jflow.FlowConfig().to_dict() == tflow.FlowConfig().to_dict()
    for kw in (dict(backend="simulated"), dict(backend="reference"),
               dict(hwloop_corruption="bitflip"), dict(algo="k-means")):
        assert jflow.FlowConfig(**kw).to_dict() == \
            tflow.FlowConfig(**kw).to_dict()


def test_hwloop_stage_is_registered_and_raises_with_its_roadmap_item():
    """The stage is ported (ROADMAP.md A7): inserted after ``power`` it runs
    on the device its instance names and gives the reference's artifacts."""
    stage = tflow.STAGE_REGISTRY["hwloop"](device="cpu")
    pipe = tflow.Pipeline().insert_after("power", stage)
    pipe.check()
    kw = dict(array_n=8, max_trials=8, hwloop_steps=3, hwloop_rows=8)
    art = pipe.run(tflow.FlowConfig(**kw))
    want = jflow.Pipeline().insert_after(
        "power", jflow.get_stage("hwloop")).run(jflow.FlowConfig(**kw))
    assert sorted(art.keys()) == sorted(want.keys())
    for key in tflow.STAGE_REGISTRY["hwloop"].provides:
        assert_same(art[key], want[key], key)
    assert art["hwloop_energy_per_token_j"] > 0


def _out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["run", "--array-n", "8", "--max-trials", "8"],
    ["run", "--array-n", "8", "--tech", "vtr-22nm", "--algo", "kmeans",
     "--emit-xdc", "--max-trials", "8", "--n-clusters", "3"],
    ["run", "--array-n", "8", "--no-calibrate", "--clock-ns", "9.5"],
    ["sweep", "--tech", "vivado-28nm,vtr-22nm", "--algo", "kmeans,dbscan",
     "--array-n", "8", "--max-trials", "8"]],
    ids=["run", "run-xdc", "run-nocal", "sweep"])
def test_cli_prints_what_the_reference_prints(argv):
    assert _out(tmain, argv) == _out(jmain, argv)


def test_cli_config_file(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(jflow.FlowConfig(array_n=8, max_trials=8,
                                     algo="hierarchical").to_json())
    argv = ["run", "--array-n", "8", "--algo", "hierarchical", "--config",
            str(path)]
    assert _out(tmain, argv) == _out(jmain, argv)


@pytest.mark.parametrize("argv", [
    ["run", "--array-n", "8", "--tech", "vtr-22nm", "--max-trials", "8",
     "--points-probe-steps", "4"],
    ["sweep", "--tech", "vtr-22nm,vivado-28nm", "--algo", "kmeans",
     "--array-n", "8", "--max-trials", "8", "--points-levels", "3",
     "--points-probe-steps", "2"]], ids=["run", "sweep"])
def test_cli_points_out_writes_the_references_ladder(argv, tmp_path, capsys):
    """``--points-out`` writes the reference CLI's ladder file, byte for
    byte, with the probes on the CPU (``--device cpu``); and
    without a GPU and without ``--device`` it stops before the flow runs."""
    t_path, j_path = tmp_path / "t.json", tmp_path / "j.json"
    t_out = _out(tmain, argv + ["--points-out", str(t_path), "--device",
                                "cpu"])
    j_out = _out(jmain, argv + ["--points-out", str(j_path)])
    assert t_path.read_bytes() == j_path.read_bytes()
    assert t_out.replace(str(t_path), "F") == j_out.replace(str(j_path), "F")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            tmain(argv + ["--points-out", str(tmp_path / "gpu.json")])
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err
        assert not (tmp_path / "gpu.json").exists()


def test_python_m_repro_torch_flow_run():
    argv = ["run", "--array-n", "8", "--max-trials", "8"]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    outs = [subprocess.run([sys.executable, "-m", mod, *argv], env=env,
                           capture_output=True, text=True, timeout=120)
            for mod in ("repro_torch.flow", "repro.flow")]
    assert [o.returncode for o in outs] == [0, 0], outs[0].stderr
    assert outs[0].stdout == outs[1].stdout
    assert "static 6.53% runtime 12.88%" in outs[0].stdout
