"""``BENCHMARK.json`` and the files it names: every one parses, is named
within the contract's characters, is found by name, and no module of the
benchmark loads JAX or the JAX package."""

from __future__ import annotations

import ast
import json

import pytest

from bench.harness import manifest as mf

MAN = mf.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
LINE = {"why", "layer", "source"}


def test_manifest_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) \
        <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert mf.NAME_RE.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert mf.NAME_RE.match(entry[key])
    for key in entry.get("reduced", []):
        assert mf.NAME_RE.match(key)
    if "unit" in entry:
        assert mf.UNIT_RE.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in LINE & set(entry):
        assert 1 <= len(entry[key]) <= 200
        assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse_and_agree(cell):
    entry = mf.workload_entry(MAN, cell)
    spec = mf.load_cell(cell)
    assert {k: spec[k] for k in ("config", "traffic", "chips")} == \
        {k: entry[k] for k in ("config", "traffic", "chips")}
    conf = mf.load_config(entry["config"])
    traffic = mf.load_traffic(entry["traffic"])
    assert (mf.BENCH_DIR / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (mf.BENCH_DIR / "reference" / f"{conf['family']}.py").is_file()
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    e2e, layer = mf.cell_metrics(MAN, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = mf.ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("bench/")
    data = json.loads(path.read_text())
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert set(conf["reduced"]) <= set(data)
    cfg = mf.model_config(data)
    for key, field in mf.HF_FIELDS.items():
        if key in data:
            assert getattr(cfg, field) == data[key]
    for key, port in mf.PORT_FIXED.items():
        if key in data:
            assert port(cfg) == data[key]


#: Phi-4-mini-instruct's published values (its ``config.json``) of the keys
#: the port runs otherwise
PHI4_PUBLISHED = {"partial_rotary_factor": 0.75, "rms_norm_eps": 1e-05,
                  "rope_scaling": "longrope"}


def test_phi4_reduced_names_every_departure():
    data = mf.load_config("phi4-mini-3.8b")
    differ = {k for k, v in PHI4_PUBLISHED.items() if data[k] != v}
    assert differ == set(data["reduced"])


@pytest.mark.parametrize("change,refused", [
    ({"rms_norm_eps": 1e-05}, True),            # not what the port runs
    ({"partial_rotary_factor": 0.75}, True),
    ({"hidden_act": "gelu"}, True),
    ({"sliding_window": 512}, True),            # a key the port cannot apply
    ({"sliding_window": 512, "reduced": ["sliding_window"]}, False),
    ({"num_hidden_layers": 4}, False),          # applied
])
def test_model_config_refuses_what_the_port_does_not_run(change, refused):
    data = {**mf.load_config("phi4-mini-3.8b"), **change}
    if refused:
        with pytest.raises(ValueError):
            mf.model_config(data)
    else:
        cfg = mf.model_config(data)
        assert cfg.n_layers == data["num_hidden_layers"]


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_reader_found_and_moves_reported(metric):
    reader = mf.load_module("metrics", metric["name"])
    assert callable(reader.read)
    e2e_names = {m["name"] for m in MAN["end_to_end"]}
    assert metric["moves"] in e2e_names
    for cell in metric.get("workloads", CELLS):
        names = {m["name"] for m in mf.cell_metrics(MAN, cell)[0]}
        assert metric["moves"] in names, (cell, metric["name"])
    if metric["name"].split(".")[0].endswith("_roofline") or \
            "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_metric_sources():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def _top_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(mf.BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(mf.BENCH_DIR)))
def test_no_jax_imports(path):
    tops = _top_imports(path)
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if path.parent.name == "reference":
        assert "repro_torch" not in tops and "bench" not in tops


def _named_by_manifest():
    return {"configs": {c["name"] for c in MAN["configs"]},
            "traffic": {w["traffic"] for w in MAN["workloads"]},
            "workloads": set(CELLS),
            "metrics": {m["name"] for m in MAN["per_layer"]}}


DATA_FILES = sorted(
    [p for kind in ("configs", "traffic", "workloads")
     for p in (mf.BENCH_DIR / kind).glob("*.json")]
    + [p for p in (mf.BENCH_DIR / "metrics").glob("*.py")
       if p.name != "__init__.py"])


@pytest.mark.parametrize("path", DATA_FILES,
                         ids=lambda p: str(p.relative_to(mf.BENCH_DIR)))
def test_every_data_file_is_named_by_the_manifest(path):
    """A configuration, traffic, cell or reader is found by its name alone,
    so a file that no entry names is one nothing runs."""
    name = path.name[:-len(path.suffix)]
    assert mf.NAME_RE.match(name)
    assert name in _named_by_manifest()[path.parent.name]
