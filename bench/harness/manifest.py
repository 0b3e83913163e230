"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own, found by its name:

* ``bench/configs/<config>.json``: a model configuration as it is run;
* ``bench/traffic/<traffic>.json``: a traffic mix (its driver and the
  parameters the driver's generator reads);
* ``bench/workloads/<cell>.json``: a cell (configuration, traffic, chips)
  and the limits its correctness check holds the run to;
* ``bench/metrics/<metric>.py``: the reader of a per-layer metric;
* ``bench/drivers/<driver>.py``: a traffic driver;
* ``bench/reference/<family>.py``: a plain reference.

Nothing here imports the program: the configuration becomes a
``repro_torch`` ``ModelConfig`` only in :func:`model_config`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

#: published (Hugging Face) keys of a configuration file -> the
#: ``repro_torch`` ``ModelConfig`` field each sets
HF_FIELDS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "head_dim": "d_head",
    "kv_channels": "d_head",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "attention_bias": "qkv_bias",
    "mamba_d_state": "ssm_state",
    "mamba_headdim": "ssm_d_head",
    "chunk_size": "ssm_chunk",
}

#: published keys that the port has no field for: the one value it runs,
#: from its ``ModelConfig``
PORT_FIXED = {
    "hidden_act": lambda cfg: {"swiglu": "silu"}.get(cfg.act, cfg.act),
    "mlp_bias": lambda cfg: False,
    "tie_word_embeddings": lambda cfg: True,
    "torch_dtype": lambda cfg: cfg.dtype,
    "partial_rotary_factor": lambda cfg: 1.0,
    "rope_scaling": lambda cfg: None,
    "rms_norm_eps": lambda cfg: 1e-6,
}

#: a configuration file's own keys, which say nothing of the model
FILE_KEYS = {"name", "source", "paper", "arch", "family", "backend",
             "reduced", "assumed", "port"}


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def load_manifest(path: Path = MANIFEST) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: the benchmark runs from "
                                "the root of a checkout")
    return _read_json(path)


def _named(kind: str, name: str) -> Path:
    if not NAME_RE.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return BENCH_DIR / kind / f"{name}.json"


def load_config(name: str) -> Dict[str, Any]:
    return _read_json(_named("configs", name))


def load_traffic(name: str) -> Dict[str, Any]:
    return _read_json(_named("traffic", name))


def load_cell(name: str) -> Dict[str, Any]:
    return _read_json(_named("workloads", name))


def workload_entry(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in manifest['workloads']]}")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(manifest: Dict[str, Any], cell: str):
    """(end-to-end metrics, per-layer metrics) a cell reports.  A per-layer
    metric without ``workloads`` goes to every cell that reports the
    end-to-end metric it ``moves``."""
    e2e = [m for m in manifest["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if ("workloads" in m and cell in m["workloads"])
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so it is loaded from its path, not imported by name)."""
    if not NAME_RE.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    if "." not in name:
        return importlib.import_module(f"bench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_config(conf: Dict[str, Any], smoke: bool = False):
    """The ``repro_torch`` ``ModelConfig`` a configuration file describes:
    the port's registered ``arch``, with every published key of the file
    that has a field (``HF_FIELDS``) and its ``port`` fields set on it.
    Every other key of the file has to be one whose value the port runs
    (``PORT_FIXED``), or be listed in ``reduced``; a file that states what
    the port does not run is refused.  ``smoke`` gives the arch's smoke
    preset instead (the CPU tests' size)."""
    from repro_torch.configs import get_config
    if smoke:
        return get_config(conf["arch"], smoke=True)
    fields = {field: conf[key] for key, field in HF_FIELDS.items()
              if key in conf}
    fields.update(conf.get("port", {}))
    cfg = dataclasses.replace(get_config(conf["arch"]), **fields)
    for key in set(conf) - FILE_KEYS - set(HF_FIELDS):
        if key in PORT_FIXED:
            if PORT_FIXED[key](cfg) != conf[key]:
                raise ValueError(f"{conf['name']}: {key} is {conf[key]!r}, "
                                 f"the port runs {PORT_FIXED[key](cfg)!r}")
        elif key not in conf.get("reduced", ()):
            raise ValueError(f"{conf['name']}: the port cannot apply {key}; "
                             "list it in reduced or leave it out")
    return cfg


def limits_of(cell: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in cell.get("limits", {}).items()}


def smoke_traffic(traffic: Dict[str, Any]) -> Dict[str, Any]:
    """The traffic at the CPU tests' size: its ``smoke`` entries over its
    parameters."""
    out = {k: v for k, v in traffic.items() if k != "smoke"}
    out.update(traffic.get("smoke", {}))
    return out


__all__ = ["BENCH_DIR", "ROOT", "MANIFEST", "NAME_RE", "UNIT_RE",
           "load_manifest", "load_config", "load_traffic", "load_cell",
           "workload_entry", "cell_metrics", "load_module", "model_config",
           "limits_of", "smoke_traffic"]
