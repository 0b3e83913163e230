"""The port's roofline (``repro_torch.roofline``) and dry run
(``repro_torch.launch.dryrun``) against the JAX package's, on the CPU.

* ``analytic``: equal to the reference's for every (arch x shape), as
  floats (the same config arithmetic).
* ``comms.CollectiveOp``: the reference's ring models
  (``tests/test_roofline.py``'s numbers).
* ``power_report.all_rows()``: equal to the reference's, field by field.
* ``estimate``: the unroll delta of 1 and 2 layer units, extrapolated to 4
  layers, equals a direct trace at 4 layers (the port's trace counts every
  layer, so the delta is exact up to float rounding: 1e-12 relative).
* ``analysis.build_row`` on hand-written artifacts: the reference's row
  once the reference's constants are the H100's.
* ``dryrun``: a smoke cell on the production mesh writes where it is told,
  never under ``artifacts/dryrun`` or ``artifacts/roofline`` (whose
  presence turns on the reference's own artifact tests).
"""

import dataclasses
import json
from pathlib import Path

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.roofline import analysis as janalysis
from repro.roofline import analytic as janalytic
from repro.roofline import power_report as jpower
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.roofline import analysis, analytic, estimate, power_report
from repro_torch.roofline.comms import (CollectiveOp, functional_kind,
                                        summarize_collectives,
                                        total_collective_bytes)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_equals_the_reference(arch):
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    assert analytic.active_params(tcfg) == janalytic.active_params(jcfg)
    for name in SHAPES:
        ts, js = SHAPES[name], J_SHAPES[name]
        for fn in ("forward_flops", "model_flops"):
            assert getattr(analytic, fn)(tcfg, ts) == getattr(
                janalytic, fn)(jcfg, js), (fn, name)
        for chips in (256, 512):
            assert analytic.hbm_bytes_per_device(tcfg, ts, chips) == \
                janalytic.hbm_bytes_per_device(jcfg, js, chips), name
    int8 = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    assert analytic.hbm_bytes_per_device(
        int8, SHAPES["decode_32k"], 256) == janalytic.hbm_bytes_per_device(
        dataclasses.replace(jcfg, kv_cache_dtype="int8"),
        J_SHAPES["decode_32k"], 256)


def test_collective_wire_models():
    ar = CollectiveOp("all-reduce", result_bytes=1000, group=4, line="")
    assert ar.wire_bytes == int(2 * 1000 * 3 / 4)
    ag = CollectiveOp("all-gather", result_bytes=1000, group=4, line="")
    assert ag.operand_bytes == 250
    assert ag.wire_bytes == 750
    rs = CollectiveOp("reduce-scatter", result_bytes=16 * 64 * 4, group=4,
                      line="")
    assert rs.operand_bytes == 16 * 64 * 4 * 4
    assert CollectiveOp("collective-permute", 128, 2, "").wire_bytes == 128
    a2a = CollectiveOp("all-to-all", 2048, 4, "")
    assert a2a.wire_bytes == 1536 and a2a.operand_bytes == 2048


def test_summarize_and_totals():
    ops = [CollectiveOp(functional_kind(n), b, g, n) for n, b, g in (
        ("all_gather_into_tensor", 8 * 1024, 16), ("all_reduce", 4096, 4),
        ("reduce_scatter_tensor", 1024, 4), ("all_to_all_single", 512, 2),
        ("all_reduce", 4096, 4))]
    s = summarize_collectives(ops)
    assert s["all-reduce"]["count"] == 2 and s["all-gather"]["count"] == 1
    assert set(s) == {"all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all"}
    op_b, wire_b = total_collective_bytes(ops)
    assert op_b == sum(o.operand_bytes for o in ops) > 0
    assert wire_b == sum(v["wire_bytes"] for v in s.values()) > 0
    assert functional_kind("wait_tensor") is None


def test_power_report_equals_the_reference():
    got = [dataclasses.asdict(r) for r in power_report.all_rows()]
    want = [dataclasses.asdict(r) for r in jpower.all_rows()]
    assert len(got) == len(want) > 30
    assert got == want
    assert power_report.render_markdown(power_report.all_rows()[:3]) == \
        jpower.render_markdown(jpower.all_rows()[:3])


def test_power_report_cli_writes_only_where_asked(tmp_path, capsys):
    out = tmp_path / "power.json"
    power_report.main(["--json-out", str(out)])
    rows = json.loads(out.read_text())["rows"]
    assert len(rows) > 30 and rows[0]["arch"] in ARCHS
    power_report.main([])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["power.json"]
    assert "| arch | shape |" in capsys.readouterr().out


def _artifacts(root: Path, arch="phi4-mini-3.8b", shape="train_4k"):
    cell = {"arch": arch, "shape": shape, "mesh": "pod_16x16",
            "status": "ok", "kind": "train", "chips": 256,
            "memory": {"argument_bytes": 3 * 2**30, "output_bytes": 0,
                       "temp_bytes": 5 * 2**30, "alias_bytes": 0},
            "cost": {"flops": 1.0e14, "bytes accessed": 3.0e12},
            "collectives": {}, "collective_operand_bytes": 4.0e9,
            "collective_wire_bytes": 6.0e9}
    est = {"arch": arch, "shape": shape, "mesh": "pod_16x16",
           "status": "ok", "estimate": {"flops": 2.0e14, "bytes": 5.0e12,
                                        "coll_wire": 7.0e9,
                                        "coll_operand": 3.0e9}}
    for sub, rec in (("dryrun", cell), ("roofline", est)):
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / f"{arch}_{shape}_pod_16x16.json").write_text(
            json.dumps(rec))


@pytest.mark.parametrize("with_estimate", [True, False])
def test_build_row_is_the_reference_row_on_h100_constants(
        tmp_path, monkeypatch, with_estimate):
    _artifacts(tmp_path)
    if not with_estimate:
        (tmp_path / "roofline" / "phi4-mini-3.8b_train_4k_pod_16x16.json"
         ).unlink()
    monkeypatch.setattr(janalysis, "ART", tmp_path)
    monkeypatch.setattr(janalysis, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(janalysis, "HBM_BW", tmesh.HBM_BW)
    monkeypatch.setattr(janalysis, "ICI_LINKS_PER_CHIP", 1)
    monkeypatch.setattr(janalysis, "ICI_LINK_BW",
                        tmesh.NVLINK_BW_PER_DIRECTION)
    got = dataclasses.asdict(analysis.build_row(
        "phi4-mini-3.8b", "train_4k", "pod_16x16", art=tmp_path))
    want = dataclasses.asdict(janalysis.build_row(
        "phi4-mini-3.8b", "train_4k", "pod_16x16"))
    if not with_estimate:
        assert got.pop("reason") == "trace"
        assert want.pop("reason").startswith("scan-raw")
    assert got == want
    assert got["t_compute"] > 0 and got["dominant"] in (
        "compute", "memory", "collective")
    missing = analysis.build_row("phi4-mini-3.8b", "decode_32k", "pod_16x16",
                                 art=tmp_path)
    assert missing.status == "missing"
    table = analysis.render_markdown(analysis.all_rows(art=tmp_path))
    assert "traced/model" in table and "missing" in table


def _no_reference_artifacts():
    for sub in ("dryrun", "roofline"):
        assert not (ROOT / "artifacts" / sub).exists()


def test_dryrun_smoke_cell_writes_where_told(tmp_path):
    rec = dryrun.run_cell("phi4-mini-3.8b", "decode_32k", smoke=True,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["cost"]["flops"] > 0 and rec["trace_s"] > 0
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert rec["collective_wire_bytes"] >= 0 and "hlo_bytes" not in rec
    path = dryrun.save(rec, tmp_path)
    assert path.parent == tmp_path and json.loads(path.read_text()) == rec
    assert dryrun.ARTIFACT_DIR == ROOT / "artifacts" / "torch" / "dryrun"
    assert estimate.ARTIFACT_DIR == ROOT / "artifacts" / "torch" / "roofline"
    skipped = dryrun.run_cell("phi4-mini-3.8b", "long_500k", smoke=True,
                              verbose=False)
    assert skipped["status"] == "skipped"
    assert dryrun.parse_overrides(["moe_impl=ep_a2a", "n_experts=4",
                                   "capacity_factor=0.5"]) == {
        "moe_impl": "ep_a2a", "n_experts": 4, "capacity_factor": 0.5}
    _no_reference_artifacts()


def test_estimate_delta_equals_a_direct_trace(tmp_path):
    """The 1- and 2-unit traces, extrapolated to 4 layers, give what a
    4-layer trace gives: the port's trace counts every layer."""
    est = estimate.estimate_cell(
        "phi4-mini-3.8b", "decode_32k", smoke=True,
        extra_overrides=None)
    assert est["status"] == "ok", est.get("traceback")
    per = {k: est["estimate"][k + "_per_unit"] for k in (
        "flops", "bytes", "coll_wire", "coll_operand")}
    fixed = {k: est["estimate"][k + "_fixed"] for k in per}
    direct = dryrun.run_cell("phi4-mini-3.8b", "decode_32k", smoke=True,
                             verbose=False, overrides={"n_layers": 4})
    assert direct["status"] == "ok"
    want = {"flops": direct["cost"]["flops"],
            "bytes": direct["cost"]["bytes accessed"],
            "coll_wire": direct["collective_wire_bytes"],
            "coll_operand": direct["collective_operand_bytes"]}
    for k in per:
        assert fixed[k] + 4 * per[k] == pytest.approx(want[k], rel=1e-12), k
    assert per["flops"] > 0
    path = estimate.save(est, tmp_path)
    assert path.parent == tmp_path
    _no_reference_artifacts()
