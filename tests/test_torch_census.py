"""The port's dispatch census (``repro_torch.analysis.census``) against the
JAX package's jaxpr census: every ``CENSUS_ARCHS`` config on ``reference``
against the pins of ``census_baseline.json`` (routed GEMMs = the pins'
``pure_callbacks``), on ``ideal`` against a live jaxpr walk of the JAX
package's ideal model; the gate's failure modes; the checked-in
``census_baseline_torch.json`` against a fresh CPU census; the CLI.

The JAX side is walked here on ``jax.extend.core`` (``repro.analysis.jaxpr``
reaches ``jax.core.ClosedJaxpr``, which jax 0.9 no longer has).  Where the
two stacks lower the same model to other numbers of products, the test names
the piece and measures it on the JAX side (a jaxpr walk of that piece alone
at the call's shapes), so every relation is exact:

* rwkv6's WKV: the reference runs ``wkv6_chunked``'s einsums
  (``src/repro/models/ssm.py:257``) as dots; the port runs the ``wkv6``
  kernel, one call a layer (its plain version's einsums count under the
  kernel).  zamba2's chunked SSD (``mamba2_forward``, ``:95``) has no
  census call: zamba2 absorbs prompts by decode steps, and both stacks run
  ``mamba2_step``'s einsums there;
* ``mamba2_step``'s ``einsum("bn,bh,bhp->bhnp")`` (``ssm.py:200``) is two
  ``dot_general`` s without a contraction under XLA, elementwise products
  under torch (its ``einsum("bn,bhnp->bhp")`` is one product in both);
* the MoE combine ``einsum("etd,te->td")`` (``src/repro/models/layers.py:446``)
  is a dot under XLA; the port sums the experts in index order in f32
  (ROADMAP C11), no product;
* seamless's prefill: the reference's jaxpr projects each decoder layer's
  prompt K/V a second time (a second ``_qkv``: q, k and v, 3 GEMMs a
  decoder layer); the port fills its cache from ``attention``'s own K/V
  (ROADMAP C4), so its routed GEMMs (``reference``) or dots (``ideal``) are
  3 a decoder layer fewer.
"""

import copy
import dataclasses
import json
import math
from collections import Counter
from pathlib import Path

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import ssm as jssm
from repro.models.api import model_api as jmodel_api
from repro.models.shardlib import spec_tree_to_structs
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.census import (CENSUS_ARCHS, MAX_LEN, PROMPT_LEN,
                                         SLOTS, census, census_advice,
                                         census_config, check_census,
                                         count_call)
from repro_torch.configs import get_config

REPO_ROOT = Path(__file__).resolve().parents[1]
PINS = REPO_ROOT / "census_baseline.json"
BASELINE = REPO_ROOT / "census_baseline_torch.json"


# ---- the JAX side: a jaxpr walk on jax.extend.core --------------------------


def _sub_jaxprs(params):
    def visit(v):
        if isinstance(v, (jcore.Jaxpr, jcore.ClosedJaxpr)):
            yield v
        elif isinstance(v, (tuple, list)):
            for item in v:
                yield from visit(item)
    for v in params.values():
        yield from visit(v)


def _walk(jaxpr, counts, weight=1):
    if isinstance(jaxpr, jcore.ClosedJaxpr):
        jaxpr = jaxpr.jaxpr
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "pure_callback":
            counts["pure_callbacks"] += weight
        elif prim in ("dot_general", "dot"):
            (lhs_c, _), _ = eqn.params["dimension_numbers"]
            k = math.prod(eqn.invars[0].aval.shape[a] for a in lhs_c)
            out = eqn.outvars[0].aval
            counts["dots"] += weight
            counts["flops"] += weight * 2 * math.prod(out.shape) * k
            counts["dot_dtypes"][str(out.dtype)] += weight
        sub_weight = weight
        if prim == "scan" and isinstance(eqn.params.get("length"), int):
            sub_weight = weight * eqn.params["length"]
        for sub in _sub_jaxprs(eqn.params):
            _walk(sub, counts, sub_weight)


def jaxpr_counts(fn, *args):
    counts = {"pure_callbacks": 0, "dots": 0, "flops": 0,
              "dot_dtypes": Counter()}
    _walk(jax.make_jaxpr(fn)(*args), counts)
    return counts


def _struct(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def jax_ideal_census(arch):
    """The JAX package's ideal census of one config, as its census traces
    it (``repro.analysis.jaxpr.census_config``'s shapes)."""
    cfg = jget_config(arch, smoke=True)
    api = jmodel_api(cfg, backend="ideal")
    shape = JShapeConfig("census", MAX_LEN, SLOTS, "decode")
    params = spec_tree_to_structs(api.param_specs())
    state = spec_tree_to_structs(api.decode_state_specs(shape))
    out = {"decode": jaxpr_counts(api.decode_step, params, state,
                                  _struct((SLOTS, 1), jnp.int32)),
           "prefill": None}
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        batch = {"tokens": _struct((1, PROMPT_LEN), jnp.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _struct(
                (1, MAX_LEN // cfg.enc_frames_ratio, cfg.d_model),
                jnp.bfloat16)
        out["prefill"] = jaxpr_counts(
            lambda p, b: api.prefill(p, b, max_len=MAX_LEN), params, batch)
    return out


# ---- the named pieces that lower to other products --------------------------


def _scaled(counts, n):
    return {"dots": n * counts["dots"], "flops": n * counts["flops"],
            "dot_dtypes": Counter({k: n * v for k, v in
                                   counts["dot_dtypes"].items()})}


def port_gap(arch, phase, backend, port):
    """What the JAX package's census holds beyond the port's for one call:
    ``gemms`` (routed GEMMs) and the dots, flops and dtypes of the named
    pieces, each measured on the JAX side."""
    cfg = jget_config(arch, smoke=True)
    gap = {"gemms": 0, "dots": 0, "flops": 0, "dot_dtypes": Counter()}

    def add(piece):
        gap["dots"] += piece["dots"]
        gap["flops"] += piece["flops"]
        gap["dot_dtypes"].update(piece["dot_dtypes"])

    b = SLOTS if phase == "decode" else 1
    s = 1 if phase == "decode" else PROMPT_LEN
    if cfg.family == "ssm":
        # wkv6_chunked at the call's shape, once a kernel call
        dims = jssm.rwkv6_dims(cfg)
        h, p = dims["h"], dims["p"]
        seq = _struct((b, s, h, p))
        piece = jaxpr_counts(
            lambda r, k, v, w, u, st: jssm.wkv6_chunked(
                r, k, v, w, u, st, cfg.ssm_chunk or 64),
            seq, seq, seq, seq, _struct((h, p)), _struct((b, h, p, p)))
        assert piece["dots"] > 0
        add(_scaled(piece, port["kernel_calls"]["wkv6"]))
    if cfg.family == "hybrid" and phase == "decode":
        dims = jssm.mamba2_dims(cfg)
        h, p, n = dims["n_heads"], dims["p"], dims["d_state"]
        piece = jaxpr_counts(
            lambda B, dt, x: jnp.einsum("bn,bh,bhp->bhnp", B, dt, x),
            _struct((b, n)), _struct((b, h)), _struct((b, h, p)))
        assert piece["dots"] == 2
        add(_scaled(piece, cfg.n_layers))
    if cfg.family == "moe":
        t = b * s
        piece = jaxpr_counts(
            lambda y, g: jnp.einsum("etd,te->td", y, g),
            _struct((cfg.n_experts, t, cfg.d_model), jnp.bfloat16),
            _struct((t, cfg.n_experts), jnp.bfloat16))
        assert piece["dots"] == 1
        add(_scaled(piece, cfg.n_layers))
    if cfg.family == "encdec" and phase == "prefill":
        L = cfg.n_layers
        if backend == "reference":
            gap["gemms"] += 3 * L
        else:
            add({"dots": 3 * L,
                 "flops": 2 * L * PROMPT_LEN * cfg.d_model
                 * (cfg.q_dim + 2 * cfg.kv_dim),
                 "dot_dtypes": Counter({"bfloat16": 3 * L})})
    return gap


# ---- fixtures ---------------------------------------------------------------


@pytest.fixture(scope="module")
def fresh():
    return census(device="cpu")


@pytest.fixture(scope="module")
def pins():
    return json.loads(PINS.read_text())


@pytest.fixture(scope="module")
def baseline():
    return json.loads(BASELINE.read_text())


def _phases(report):
    return [(ph, report[ph]) for ph in ("prefill", "decode")
            if report[ph] is not None]


# ---- the port against the JAX package ---------------------------------------


@pytest.mark.parametrize("arch", CENSUS_ARCHS)
def test_reference_census_equals_the_pins_of_the_jax_package(arch, fresh,
                                                             pins):
    report = fresh["backends"]["reference"]["configs"][arch]
    pinned = pins["configs"][arch]
    assert report["family"] == pinned["family"]
    for phase in ("prefill", "decode"):
        assert (report[phase] is None) == (pinned[phase] is None), phase
    for phase, cur in _phases(report):
        base = pinned[phase]
        gap = port_gap(arch, phase, "reference", cur)
        assert cur["backend_gemms"] + gap["gemms"] == base["pure_callbacks"]
        assert cur["dots"] + gap["dots"] == base["dots"], phase
        assert cur["flops"] + gap["flops"] == base["flops"], phase
        assert Counter(cur["dot_dtypes"]) + gap["dot_dtypes"] == Counter(
            base["dot_dtypes"]), phase
        # each routed GEMM is one systolic_mac call; rwkv6's recurrence one
        # wkv6 call a layer
        cfg = get_config(arch, smoke=True)
        want = {"systolic_mac": cur["backend_gemms"]}
        if cfg.family == "ssm":
            want["wkv6"] = cfg.n_layers
        assert cur["kernel_calls"] == want
        assert cur["backend_gemms"] > 0 and cur["host_syncs"] == 0
    # the gaps are the named pieces only: no gap where the stacks agree
    if arch in ("starcoder2-3b", "llava-next-mistral-7b"):
        for phase, cur in _phases(report):
            assert port_gap(arch, phase, "reference", cur) == {
                "gemms": 0, "dots": 0, "flops": 0, "dot_dtypes": Counter()}


@pytest.mark.parametrize("arch", CENSUS_ARCHS)
def test_ideal_census_equals_a_live_jaxpr_walk(arch, fresh):
    report = fresh["backends"]["ideal"]["configs"][arch]
    live = jax_ideal_census(arch)
    for phase in ("prefill", "decode"):
        assert (report[phase] is None) == (live[phase] is None), phase
    for phase, cur in _phases(report):
        want = live[phase]
        gap = port_gap(arch, phase, "ideal", cur)
        assert want["pure_callbacks"] == 0 and cur["backend_gemms"] == 0
        assert cur["backend_gemms"] + cur["dots"] + gap["dots"] == \
            want["dots"], phase
        assert cur["flops"] + gap["flops"] == want["flops"], phase
        assert Counter(cur["dot_dtypes"]) + gap["dot_dtypes"] == \
            want["dot_dtypes"], phase
        assert "systolic_mac" not in cur["kernel_calls"]
    if arch == "starcoder2-3b":       # the numbers the JAX census gives
        assert [(report[ph]["dots"], report[ph]["flops"])
                for ph in ("decode", "prefill")] == [(17, 1245184),
                                                     (17, 3866624)]
    if arch == "rwkv6-1.6b":
        assert live["decode"]["dots"] == 33
        assert live["decode"]["flops"] == 1708032
        assert dict(live["decode"]["dot_dtypes"]) == {"bfloat16": 19,
                                                      "float32": 14}


def test_checked_in_baseline_equals_a_fresh_cpu_census(fresh, baseline):
    assert baseline == json.loads(json.dumps(fresh))
    assert check_census(fresh, baseline) == []
    assert sorted(baseline["backends"]) == ["ideal", "reference"]
    assert baseline["device"] == "cpu"


def test_census_counts_syncs_at_their_sites():
    """Host reads the dispatcher sees (on CPU tensors: the scalar reads and
    the data-sized ops) are counted with the frame that made them; the
    products inside a kernel's plain version are the kernel's."""
    from repro_torch.kernels.wkv6 import wkv6

    x = torch.arange(6.0).reshape(2, 3)

    def body():
        int(x.sum())
        torch.nonzero(x)
        x[x > 2]
        x @ x.T
        r = torch.zeros(1, 2, 1, 4)
        wkv6(r, r, r, r, torch.zeros(1, 4), torch.zeros(1, 1, 4, 4), chunk=2)

    got = count_call(body)
    assert got["host_syncs"] == 3
    assert got["dots"] == 1 and got["flops"] == 2 * 4 * 3
    assert got["kernel_calls"] == {"wkv6": 1}
    sites = [s["site"] for s in got["host_sync_sites"]]
    assert all("test_torch_census.py" in s for s in sites), sites
    assert any(s.startswith("aten._local_scalar_dense") for s in sites)


# ---- the gate (mirrors tests/analysis/test_census.py) ------------------------


def _call(report, arch="starcoder2-3b", phase="decode", backend="reference"):
    return report["backends"][backend]["configs"][arch][phase]


def test_gate_passes_on_identical_census(baseline):
    assert check_census(baseline, baseline) == []


def test_gate_fails_on_new_host_sync(baseline):
    worse = copy.deepcopy(baseline)
    _call(worse)["host_syncs"] += 1
    problems = check_census(worse, baseline)
    assert any("host_syncs rose" in p for p in problems)
    # a DROP is fine (the CUDA-graph work succeeding): advice, not failure
    base = copy.deepcopy(baseline)
    _call(base)["host_syncs"] = 3
    better = copy.deepcopy(base)
    _call(better)["host_syncs"] = 0
    assert check_census(better, base) == []
    assert any("host_syncs fell 3 -> 0" in a
               for a in census_advice(better, base))


@pytest.mark.parametrize("key", ["dots", "backend_gemms", "kernel_calls"])
def test_gate_fails_on_pinned_drift(baseline, key):
    drifted = copy.deepcopy(baseline)
    call = _call(drifted, "rwkv6-1.6b")
    if key == "kernel_calls":
        call[key] = {**call[key], "wkv6": call[key]["wkv6"] - 1}
    else:
        call[key] -= 1
    problems = check_census(drifted, baseline)
    assert any(f"{key} changed" in p for p in problems), problems


def test_gate_fails_on_missing_config_backend_or_call(baseline):
    partial = copy.deepcopy(baseline)
    del partial["backends"]["reference"]["configs"]["starcoder2-3b"]
    assert any("missing from current census" in p
               for p in check_census(partial, baseline))
    no_ideal = copy.deepcopy(baseline)
    del no_ideal["backends"]["ideal"]
    assert any("ideal: backend missing" in p
               for p in check_census(no_ideal, baseline))
    gone = copy.deepcopy(baseline)
    gone["backends"]["ideal"]["configs"]["llava-next-mistral-7b"][
        "prefill"] = None
    assert any("presence changed" in p for p in check_census(gone, baseline))


# ---- the CLI ----------------------------------------------------------------


def test_cli_census_exit_codes(capsys, tmp_path):
    assert cli.main(["census", "--device", "cpu", "--check",
                     str(BASELINE)]) == 0
    assert "census gate: OK" in capsys.readouterr().out
    # one config against the whole baseline: the others are missing
    assert cli.main(["census", "--device", "cpu", "--arch", "starcoder2-3b",
                     "--backend", "ideal", "--check", str(BASELINE)]) == 1
    assert "CENSUS GATE" in capsys.readouterr().out
    out = tmp_path / "c.json"
    assert cli.main(["census", "--device", "cpu", "--arch", "rwkv6-1.6b",
                     "--baseline", str(out), "--write-baseline"]) == 0
    pinned = json.loads(out.read_text())
    assert list(pinned["backends"]["reference"]["configs"]) == ["rwkv6-1.6b"]
    assert cli.main(["census", "--device", "cpu", "--arch", "rwkv6-1.6b",
                     "--check", str(out)]) == 0


def test_cli_census_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        cli.main(["census", "--arch", "starcoder2-3b"])


def test_census_runs_with_the_bf16_recurrence(monkeypatch):
    """cfg.ssm_bf16=True: the same structure, the recurrence on wkv6 (bf16
    operands), one call a layer."""
    import repro_torch.configs as configs_mod

    def bf16_config(arch, smoke=False):
        return dataclasses.replace(get_config(arch, smoke=smoke),
                                   ssm_bf16=True)

    monkeypatch.setattr(configs_mod, "get_config", bf16_config)
    rep = census_config("rwkv6-1.6b", "reference", device="cpu")
    assert rep["decode"]["kernel_calls"] == {"systolic_mac": 21, "wkv6": 2}
    assert rep["decode"]["dots"] == 0


def test_the_bf16_wkv6_launches_count_under_wkv6():
    """On the card the bf16 wkv6 is counted by ``wkv6.bf16_launches``; the
    census reads it under ``wkv6`` beside the f32 kernel's ``launches``, as
    the CPU counts both routes' plain-version calls, so an ssm_bf16 config
    gives the same ``kernel_calls`` on both devices."""
    from repro_torch.kernels.wkv6 import wkv6

    def launch():
        wkv6.launches += 1
        wkv6.bf16_launches += 2

    saved = wkv6.launches, wkv6.bf16_launches
    try:
        rep = count_call(launch)
    finally:
        wkv6.launches, wkv6.bf16_launches = saved
    assert rep["kernel_calls"] == {"wkv6": 3}
