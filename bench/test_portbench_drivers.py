"""Each driver through its functions at the smoke size on the CPU; the
run's ``correct`` with the timed path broken underneath (the faults a cell
can have); and the measurement path, which exits without a result where
there is no card or no program."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from bench import run as bench_run
from bench.harness import common, manifest as mf, traffic as gen

CPU = torch.device("cpu")
CELLS = [w["name"] for w in mf.load_manifest()["workloads"]]


def seconds(cell):
    """A window long enough that a served smoke run finishes requests on a
    loaded CPU; a scored or trained one makes at least one call anyway."""
    traffic = mf.load_traffic(mf.load_cell(cell)["traffic"])
    return 1.0 if traffic["driver"] == "serve" else 0.2


def _run(cell, seed=20260101):
    ctx = common.build_context(cell, seed, seconds(cell), smoke=True,
                               device=CPU)
    return ctx, common.driver(ctx).run(ctx)


def _line(monkeypatch, cell, seed=20260101):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    ctx, rec = _run(cell, seed)
    man = mf.load_manifest()
    e2e, layer = mf.cell_metrics(man, cell)
    return bench_run.result_line(rec, ctx, e2e, layer, 1), e2e


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_at_smoke_size(monkeypatch, cell):
    """The line's shape; ``correct`` is the cell's limits on its numbers
    (set for the cell's own size, which only the chip runs: a smoke model's
    bf16 rounding is not a full-size one's)."""
    line, e2e = _line(monkeypatch, cell)
    limits = mf.limits_of(mf.load_cell(cell))
    assert set(line["checks"]) == set(limits)
    assert line["correct"] == all(c["value"] <= c["limit"]
                                  for c in line["checks"].values())
    assert all(0 <= c["value"] < 1 for c in line["checks"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"


def _fault_serve_token(monkeypatch):
    from repro_torch.serve import engine
    emit = engine.ServeEngine._emit
    monkeypatch.setattr(engine.ServeEngine, "_emit",
                        lambda self, slot, req, tok: emit(self, slot, req,
                                                          tok + 1))


def _fault_serve_state(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "_cache_write", lambda *a: None)


def _fault_half_batch(monkeypatch):
    from repro_torch.models.api import ModelAPI
    for name in ("loss", "train_loss"):
        orig = getattr(ModelAPI, name)

        def half(self, params, batch, _orig=orig):
            rows = batch["tokens"].shape[0] // 2
            return _orig(self, params, {k: v[:rows] for k, v in batch.items()})
        monkeypatch.setattr(ModelAPI, name, half)


def _fault_answer(monkeypatch):
    from repro_torch.models.api import ModelAPI
    orig = ModelAPI.loss
    monkeypatch.setattr(ModelAPI, "loss",
                        lambda self, p, b: orig(self, p, b) * 1.01)


def _fault_train_state(monkeypatch):
    from repro_torch.train import trainer
    monkeypatch.setattr(trainer.optim, "apply_updates",
                        lambda params, state, grads, cfg: (params, state))


FAULTS = {
    "serve": [_fault_serve_token, _fault_serve_state],
    "score": [_fault_half_batch, _fault_answer],
    "train": [_fault_half_batch, _fault_train_state],
}


@pytest.mark.parametrize("cell,fault", [
    (cell, f) for cell in CELLS
    for f in FAULTS[mf.load_traffic(mf.load_cell(cell)["traffic"])["driver"]]],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    line, _ = _line(monkeypatch, cell)
    assert not line["correct"], line["checks"]


def test_no_result_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cmd = [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
           "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=mf.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # a folder with the benchmark's files alone holds no program either
    bare = tmp_path / "bare"
    shutil.copytree(mf.BENCH_DIR, bare / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(mf.MANIFEST, bare / "BENCHMARK.json")
    out = subprocess.run(cmd, cwd=bare, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_jax_modules_are_found():
    assert common.forbidden_loaded(["repro_torch.serve", "numpy",
                                    "reprox"]) == []
    assert common.forbidden_loaded(["repro.models.lm", "jax._src.core",
                                    "flax", "torch"]) == ["flax", "jax",
                                                          "repro"]


def test_every_seed_gets_the_same_work():
    tp = mf.load_traffic("azure-conv-c64")
    streams = [gen.RequestStream(seed, tp, 200_064) for seed in (1, 2 ** 33)]
    firsts = [[next(s) for _ in range(2 * tp["block"])] for s in streams]
    lengths = [sorted((r.prompt_len, r.max_new) for r in f) for f in firsts]
    assert lengths[0] == lengths[1]
    assert [r.prompt_len for r in firsts[0]] != \
        [r.prompt_len for r in firsts[1]]
    assert all(len(r.tokens) == r.prompt_len for r in firsts[0])
    assert min(lengths[0])[0] >= tp["prompt"][0]
    assert max(p for p, _ in lengths[0]) <= tp["prompt"][1]


SERVED = sorted({mf.load_cell(c)["traffic"] for c in CELLS
                 if mf.load_traffic(mf.load_cell(c)["traffic"])["driver"]
                 == "serve"})


@pytest.mark.parametrize("name", SERVED)
def test_served_lengths_fit_and_match_their_source(name):
    """Every request's prompt and output fit one slot (none is cut short),
    and the lengths' medians are the published ones the file names."""
    tp = mf.load_traffic(name)
    stream = gen.RequestStream(3, tp, 512)
    reqs = [next(stream) for _ in range(tp["block"])]
    assert max(r.prompt_len + r.max_new for r in reqs) <= tp["max_len"]
    pub = tp["published"]
    for key, lens in (("prompt_tokens_median",
                       [r.prompt_len for r in reqs]),
                      ("output_tokens_median", [r.max_new for r in reqs])):
        median = sorted(lens)[len(lens) // 2]
        assert abs(median - pub[key]) / pub[key] < 0.05, (key, median)


def test_only_a_closed_loop_is_generated():
    tp = {**mf.load_traffic(SERVED[0]), "arrival": "open"}
    with pytest.raises(ValueError):
        gen.RequestStream(1, tp, 512)

