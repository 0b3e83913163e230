"""The port's examples (``repro_torch.examples.<name>``) against the JAX
package's scripts in ``examples/``, on the CPU.

Each reference script runs as a script (``runpy.run_path`` with
``sys.argv`` patched and its output captured); the globals it leaves
(``report``, ``result``, ``reqs``, ``stats``, ``session``, ``events``,
``res``, ...) are what the port's ``run()`` is held against, on the
reference's own weights (``params_from_numpy``) and the same flags.

Tolerances:

* ``quickstart`` is host code in both packages: every printed line, every
  field of the report and the sweep's rows and table equal.
* Tokens equal up to ties (``test_torch_serve._assert_same_or_tied``, the
  C1 rule: the two stacks' logits differ by bf16 rounding noise).
* ``serve_batched``'s energies within 1e-12 relative: the same float64
  formula on the same counts.
* ``hwloop_serve``'s rails, flag rates, recalibrations, replay rate, GEMMs,
  MACs, flags and J/token equal, as ``test_torch_hwloop.py`` holds the
  serve engine's hwloop telemetry (bit for bit); where a token parts at a
  tie the batches that follow are not compared.  The undervolted
  ``emulated`` batch is the exception: its SILENT MACs (``stale``) feed
  corrupted products forward, so the stacks' bf16 noise in the activations
  reaches its tokens (compared by count only) and the DETECTED counts
  behind its replay rate and J/token, held within ``REPLAY_RTOL`` /
  ``ENERGY_RTOL`` (set after 0.48 % / 0.12 % were seen on the CPU); its
  counts that the data does not move stay exact.
* ``traffic_overload``: the trace's events equal; the wall-clock split
  between completed and shed is not compared (it depends on each host's
  speed), only that completed + shed = events in every tier.
* ``train_lm``'s losses within ``test_torch_train.py``'s ``LOSS_RTOL0`` /
  ``LOSS_RTOL`` of the reference's (its jitted ``train()`` on ``ideal``).
"""

import contextlib
import dataclasses
import importlib
import io
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.models import model_api as j_model_api
from repro_torch.configs import get_config
from repro_torch.examples import (hwloop_serve, quickstart, serve_batched,
                                  traffic_overload, train_lm)
from repro_torch.models import model_api, params_from_numpy
from test_torch_core import assert_same
from test_torch_serve import (_assert_same_or_tied, _jax_logits_alone,
                              _np_tree)
from test_torch_train import LOSS_RTOL, LOSS_RTOL0

ROOT = Path(__file__).resolve().parent.parent
#: the undervolted emulated batch (SILENT MACs on the served GEMMs): its
#: replay rate and J/token against the reference's, relative
REPLAY_RTOL, ENERGY_RTOL = 0.05, 0.01


def _script(name, argv, monkeypatch):
    """``examples/<name>.py`` run as a script with ``argv``: its globals
    and what it printed."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        g = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                           run_name="__main__")
    return g, out.getvalue()


def _port_params(arch, jparams):
    """The reference's weights as the port's tree on the CPU."""
    cfg = get_config(arch, smoke=True)
    return cfg, params_from_numpy(
        _np_tree(jparams), model_api(cfg, device="cpu").param_specs(), "cpu")


class _Recorded:
    """``repro.serve.ServeEngine`` patched to keep every engine a script
    makes, its session's rails when it was made and the requests submitted
    to it."""

    def __init__(self, monkeypatch):
        self.engines = []
        base, outer = jserve.ServeEngine, self

        class Engine(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.rails_at_start = (None if self.hwloop is None else
                                       np.array(self.hwloop.rails))
                self.submitted = []
                outer.engines.append(self)

            def submit(self, req):
                self.submitted.append(req)
                return super().submit(req)

        monkeypatch.setattr(jserve, "ServeEngine", Engine)


def _tokens_up_to_ties(got, want, jcfg, jparams, max_len):
    """Every request's tokens equal up to ties; whether all were equal."""
    japi = j_model_api(jcfg)
    for t, j in zip(got, want):
        assert (t.uid, t.prompt) == (j.uid, j.prompt)
        _assert_same_or_tied(
            t.out_tokens, j.out_tokens,
            lambda i, j=j: _jax_logits_alone(japi, jparams, j.prompt,
                                             j.out_tokens[:i], max_len),
            t.uid)
    return [t.out_tokens for t in got] == [j.out_tokens for j in want]


# ---- quickstart ------------------------------------------------------------


def test_quickstart_prints_and_computes_what_the_script_does(monkeypatch,
                                                              capsys):
    g, printed = _script("quickstart", [], monkeypatch)
    assert quickstart.main([]) == 0
    assert capsys.readouterr().out.splitlines() == printed.splitlines()
    out = quickstart.run()
    assert out.stages == [s.name for s in g["pipe"].stages]
    assert_same(out.report, g["report"], "report")
    assert out.timing_table == g["render_report_table"](g["tm"].report(5))
    cols = quickstart.SWEEP_COLUMNS
    assert out.result.table(columns=cols) == g["result"].table(columns=cols)
    assert_same(out.result.rows(), g["result"].rows(), "sweep rows")
    assert out.result.timing_stage_runs() == \
        g["result"].timing_stage_runs() == 2
    assert len(out.result.configs) == len(g["result"].configs) == 4


# ---- serve_batched ---------------------------------------------------------


def test_serve_batched_against_the_script(monkeypatch):
    argv = ["--requests", "3", "--max-new", "4"]
    g, _ = _script("serve_batched", argv, monkeypatch)
    arch = g["args"].arch
    cfg, params = _port_params(arch, g["params"])
    out = serve_batched.run(cfg, params, requests=3, max_new=4, device="cpu")
    _tokens_up_to_ties(out.reqs, g["reqs"], g["cfg"], g["params"],
                       serve_batched.MAX_LEN)
    for key in ("completed", "tokens_generated", "prefill_steps",
                "decode_steps", "admitted", "slot_busy_steps"):
        assert getattr(out.stats, key) == getattr(g["stats"], key), key
    assert all(len(r.out_tokens) == 4 for r in out.reqs)
    assert out.prompt_tokens == g["prompt_toks"]
    assert out.macs == g["macs"]
    assert_same(out.flow, g["flow"], "flow")
    for mine, theirs in ((out.base, g["base"]), (out.tuned, g["tuned"])):
        assert abs(mine - theirs) <= 1e-12 * abs(theirs)
    assert out.tuned < out.base


# ---- hwloop_serve ----------------------------------------------------------


@pytest.mark.parametrize("backend", hwloop_serve.BACKENDS)
def test_hwloop_serve_against_the_script(backend, monkeypatch):
    rec = _Recorded(monkeypatch)
    argv = ["--requests", "2", "--max-new", "3", "--backend", backend]
    g, printed = _script("hwloop_serve", argv, monkeypatch)
    cfg, params = _port_params(g["args"].arch, g["params"])
    out = hwloop_serve.run(cfg, params, backend, requests=2, max_new=3,
                           device="cpu")
    lines, want = hwloop_serve.report_lines(out), printed.splitlines()
    assert len(rec.engines) == len(out.batches) == 2 and len(want) == 5
    # the calibrated rails, the undervolt and the healed rails, bit for bit
    np.testing.assert_array_equal(out.calibrated_rails,
                                  rec.engines[0].rails_at_start)
    assert out.v_safe == g["v_safe"]
    np.testing.assert_array_equal(out.healed_rails, g["session"].rails)
    assert [lines[i] for i in (0, 2, 4)] == [want[i] for i in (0, 2, 4)]
    for i, (batch, engine) in enumerate(zip(out.batches, rec.engines)):
        hw, jhw = batch.stats.hwloop, engine.stats.hwloop
        bt, jbt = batch.stats.backend_telemetry, engine.stats.backend_telemetry
        assert (bt is None) == (jbt is None) == (backend == "probe")
        for key in ("steps", "flag_rate", "recalibrations", "rails_v",
                    "tokens", "macs", "dynamic_j"):
            assert hw[key] == jhw[key], (batch.tag, key)
        for key in ("calls", "macs", "flags") if bt is not None else ():
            assert bt[key] == jbt[key], (batch.tag, key)
        if jbt is not None and jbt["silent"] > 0:
            # SILENT MACs corrupted served products: the streams leave the
            # tie rule's reach, and the replays follow the operands
            assert bt["silent"] > 0
            assert [len(r.out_tokens) for r in batch.reqs] == \
                [len(r.out_tokens) for r in engine.submitted]
            assert hw["replay_rate"] == pytest.approx(jhw["replay_rate"],
                                                      rel=REPLAY_RTOL)
            assert hw["energy_per_token_j"] == pytest.approx(
                jhw["energy_per_token_j"], rel=ENERGY_RTOL)
            continue
        if not _tokens_up_to_ties(batch.reqs, engine.submitted, g["cfg"],
                                  g["params"], hwloop_serve.MAX_LEN):
            break       # parted at a tie: the traffic differs from here on
        for key in ("replay_rate", "energy_per_token_j"):
            assert hw[key] == jhw[key], (batch.tag, key)
        if bt is not None:
            assert (bt["replays"], bt["silent"]) == \
                (jbt["replays"], jbt["silent"])
        assert lines[1 + 2 * i] == want[1 + 2 * i]
    assert out.batches[0].stats.hwloop["recalibrations"] == 0
    assert out.batches[1].stats.hwloop["recalibrations"] >= 1
    assert out.healed_rails[0] > out.undervolt_v


# ---- traffic_overload ------------------------------------------------------


def _event_rows(events):
    """A trace's events as dicts, the priority by its tier's name (each
    package has its own ``Priority``)."""
    return [dict(dataclasses.asdict(ev), priority=ev.priority.name)
            for ev in events]


def test_traffic_overload_against_the_script(monkeypatch):
    argv = ["--duration", "1", "--rate-scale", "20"]
    g, printed = _script("traffic_overload", argv, monkeypatch)
    cfg, params = _port_params(g["args"].arch, g["params"])
    out = traffic_overload.run(cfg, params, "ideal", duration=1.0,
                               rate_scale=20.0, device="cpu")
    assert_same(_event_rows(out.events), _event_rows(g["events"]), "events")
    assert len(out.results) == len(out.events)
    for tier, split in out.by_tier.items():
        n = sum(ev.priority.name == tier for ev in out.events)
        assert split["completed"] + split["shed"] == n, tier
    assert out.drained is True
    assert {"shed_rate", "tokens_generated"} <= set(out.health)
    assert out.backend_telemetry is None
    assert out.engine.stats.backend is None
    # the script's own run: the same split holds there too
    jtiers = eval(next(line for line in printed.splitlines()
                       if line.startswith("per tier: "))[len("per tier: "):])
    for tier, split in jtiers.items():
        n = sum(ev.priority.name == tier for ev in g["events"])
        assert split["completed"] + split["shed"] == n, tier


# ---- train_lm --------------------------------------------------------------


def test_train_lm_against_the_script(monkeypatch, tmp_path):
    flags = dict(steps=4, d_model=64, layers=2, batch=2, seq=32)
    argv = [a for k, v in flags.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]
    g, printed = _script("train_lm", argv + [
        "--checkpoint-dir", str(tmp_path / "jax")], monkeypatch)
    cfg = train_lm.lm_config(flags["d_model"], flags["layers"])
    jcfg = g["cfg"]
    for f in dataclasses.fields(cfg):
        if hasattr(jcfg, f.name):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    out = train_lm.run(cfg, flags["steps"], flags["batch"], flags["seq"],
                       str(tmp_path / "torch"), device="cpu",
                       init=lambda api: params_from_numpy(
                           _np_tree(jparams), api.param_specs(), "cpu"))
    assert out.n_params == g["n_params"]
    assert printed.splitlines()[0].startswith(
        f"training {out.n_params / 1e6:.1f}M-param decoder LM (2L d=64)")
    res, want = out.res, g["res"]
    assert res.steps_done == want.steps_done == flags["steps"]
    np.testing.assert_allclose(res.losses[0], want.losses[0],
                               rtol=LOSS_RTOL0)
    np.testing.assert_allclose(res.losses, want.losses, rtol=LOSS_RTOL)
    assert [r.host_id for r in out.monitor.stragglers()] == \
        [r.host_id for r in g["monitor"].stragglers()]
    # a checkpoint every step (steps // 4 = 1), the last three kept, as the
    # script's own directory
    kept = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert kept == sorted(p.name for p in (tmp_path / "jax").iterdir())


# ---- the device: the GPU unless --device cpu is given ----------------------


@pytest.mark.parametrize("name", ["quickstart", "serve_batched",
                                  "hwloop_serve", "traffic_overload",
                                  "train_lm"])
def test_main_runs_on_the_gpu_unless_asked(name, monkeypatch):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "quickstart":
        # host code only: it takes no --device at all
        with pytest.raises(SystemExit):
            mod.main(["--device", "cpu"])
        return

    def refuse(*a, **kw):
        raise AssertionError("ran without a device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "run", refuse)
    with pytest.raises(RuntimeError, match="none is available"):
        mod.main([])
