"""The port's chaos campaign (``repro_torch.resilience.chaos``) against
``repro.resilience.chaos``, on the CPU.

The port's six scenarios run on starcoder2's smoke config with the
reference's weights (``params_from_numpy``, through the campaign's model
hook) and must all be green.  Where a scenario's details do not depend on
the wall clock they equal the reference's run of the same scenario: the
engine-level pair's guard counters, completions and recalibrations (C8 of
ROADMAP.md leaves MACs and energy out, and no detail carries them), and the
droop and guard counters of ``rail_droop``.  The wall-paced scenarios
(``slow_decode``, ``client_disconnect``, ``overload_shed``) are held to
their own balance.  Then the hooks: the fault-free truth, the default model
and the CLI's ``--device``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import repro.resilience as jres
import repro_torch.resilience as tres
from repro.configs import get_config as j_get_config
from repro.models import model_api as j_model_api
from repro_torch.configs import get_config
from repro_torch.models import model_api, params_from_numpy
from test_torch_serve import _np_tree

SRC = Path(__file__).resolve().parent.parent / "src"
ENGINE_LEVEL = ("silent_burst", "watchdog_delay")
#: scenarios the reference runs beside the port here: the engine-level pair
#: and the one wire scenario whose details are guard counters
WITH_REFERENCE = ENGINE_LEVEL + ("rail_droop",)
RAIL_DROOP_KEYS = ("crashed", "corrupted_streams", "requests", "droops",
                   "guard_detected", "guard_heals", "guard_uncorrected")


@pytest.fixture(scope="module")
def model():
    """The model hook: starcoder2 smoke with the reference's weights."""
    jcfg = j_get_config("starcoder2-3b", smoke=True)
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = get_config("starcoder2-3b", smoke=True)
    tparams = params_from_numpy(
        _np_tree(jparams), model_api(tcfg, device="cpu").param_specs(), "cpu")
    return lambda: (tcfg, tparams)


@pytest.fixture(scope="module")
def reports(model):
    port = tres.run_campaign(fast=True, model=model, device="cpu")
    ref = jres.run_campaign(fast=True, only=list(WITH_REFERENCE))
    return ({r.name: r for r in port.results},
            {r.name: r for r in ref.results}, port)


def test_scenario_registry():
    assert set(tres.SCENARIOS) == set(jres.SCENARIOS)
    with pytest.raises(KeyError):
        tres.run_scenario("rowhammer", device="cpu")
    with pytest.raises(ValueError, match="truth"):
        tres.run_scenario("silent_burst", device="cpu", truth="oracle")
    assert tres.V_CRASH == jres.chaos.V_CRASH


def test_report_aggregation_and_json():
    rep = tres.ChaosReport(results=[
        tres.ScenarioResult("a", ok=True, violations=[],
                            details={"crashed": 0, "corrupted_streams": 0}),
        tres.ScenarioResult("b", ok=False, violations=["stream 1 corrupted"],
                            details={"crashed": 1, "corrupted_streams": 2}),
    ], elapsed_s=1.5)
    assert not rep.ok
    assert rep.crashes == 1 and rep.corrupted_streams == 2
    d = json.loads(json.dumps(rep.to_dict()))
    assert d["ok"] is False and len(d["scenarios"]) == 2
    want = jres.ChaosReport(results=[
        jres.ScenarioResult(**vars(r)) for r in rep.results], elapsed_s=1.5)
    assert rep.to_dict() == want.to_dict()


def test_campaign_runs_every_scenario_green(reports):
    port, _, report = reports
    assert list(port) == list(tres.SCENARIOS)
    assert report.ok, {n: r.violations for n, r in port.items()}
    assert report.crashes == 0 and report.corrupted_streams == 0


@pytest.mark.parametrize("name", ENGINE_LEVEL)
def test_engine_level_details_equal_the_references(reports, name):
    """Every detail but the stream check, which each package makes against
    its own ideal decode: the reference's ``watchdog_delay`` turns red on
    its own here, its emulated and ideal decodes parting at request 0's
    fourth token, where its two largest logits lie 3.7e-5 of max|logits|
    apart (ROADMAP.md C1)."""
    port, ref, _ = reports
    got, want = (dict(r[name].details) for r in (port, ref))
    want.pop("flight_recorder", None)
    assert got.pop("corrupted_streams") == 0
    want.pop("corrupted_streams")
    assert got == want
    assert got["guard_heals"] >= 1 and got["completed"] == got["requests"]


def test_rail_droop_counters_equal_the_references(reports):
    port, ref, _ = reports
    assert ref["rail_droop"].ok, ref["rail_droop"].violations
    for key in RAIL_DROOP_KEYS:
        assert port["rail_droop"].details[key] == \
            ref["rail_droop"].details[key], key
    assert port["rail_droop"].details["droops"] == 1


def test_wall_paced_scenarios_balance(reports):
    port, _, _ = reports
    slow = port["slow_decode"].details
    assert slow["slow_status"] == 503 and slow["cancelled"] == 1
    assert slow["stall_s"] >= 0.3
    gone = port["client_disconnect"].details
    assert gone["cancelled"] == 1 and gone["survivor_tokens"] == 3
    shed = port["overload_shed"].details
    assert shed["shed"] >= 1
    assert shed["shed"] + shed["completed"] == shed["requests"] == 8
    assert shed["health_shed"] >= shed["shed"]
    assert shed["retry_attempts"] >= 1


@pytest.mark.parametrize("name", ["rail_droop", "watchdog_delay"])
def test_fault_free_truth(model, name):
    """The truth hook: each stream held to the same engine's run without
    the fault (``chip_smoke.py`` uses it at full width)."""
    res = tres.run_scenario(name, model=model, device="cpu",
                            truth="fault_free")
    assert res.ok, res.violations
    assert res.details["corrupted_streams"] == 0


def test_default_model_and_cli_on_the_cpu():
    """Without a model hook the campaign draws starcoder2's smoke weights
    with the port's own generator; the CLI runs on ``--device cpu``."""
    res = tres.run_scenario("overload_shed", device="cpu")
    assert res.ok, res.violations
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.resilience.chaos", "--device",
         "cpu", "--only", "client_disconnect,overload_shed"],
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    out = json.loads(done.stdout)
    assert out["ok"] and [s["name"] for s in out["scenarios"]] == [
        "client_disconnect", "overload_shed"]
