"""The slice as a whole, on the CPU: the same prompts and the same
(converted) weights through ``repro.serve.ServeEngine`` and
``repro_torch.serve.ServeEngine``, for phi4-mini-3.8b (dense: prompts
absorbed by one prefill) and rwkv6-1.6b and zamba2-2.7b (ssm, hybrid:
prompts absorbed by decode steps at batch 1) at smoke size.

Prompts are drawn with ``np.random.default_rng``.  Token streams are compared
for equality up to ties: the two stacks' logits differ by bf16 rounding noise
(``BF16_TOL`` of max|logits| each, see ``tests/test_torch_models.py``), so
where the reference's largest logits lie closer than twice that noise the
greedy token may be any of the tied ones, and the streams are compared up to
that step only (the contexts differ after it).  Everything else about the
engines (scheduling, accounting, telemetry, metric renders) is deterministic
and compared exactly.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.launch import serve as j_launch
from repro.models import model_api as j_model_api
from repro.obs import ObsBus as JObsBus
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve as t_launch
from repro_torch.models import model_api, params_from_numpy
from repro_torch.obs import ObsBus
from repro_torch.serve import (EngineStats, Request, ServeEngine,
                               WaveServeEngine)
from test_torch_encdec import without_self_kv

# mixed prompt lengths AND mixed output budgets (the workload shape of
# tests/serve/test_engine.py); token ids 3..511 of the smoke vocabulary
_RNG = np.random.default_rng(0)
PROMPTS = [_RNG.integers(3, 512, n).tolist() for n in (3, 1, 6, 2, 4)]
MAX_NEW = [4, 7, 2, 5, 3]
#: one stack's logits lie within this fraction of max|logits| of the other's
#: (four bf16 roundings, as in tests/test_torch_models.py); two logits closer
#: than twice that are tied as far as a greedy token can tell
BF16_TOL = 4 * 2.0 ** -8
CLOCK_FIELDS = ("ttft_s", "ttft_mean_s")
#: model GEMMs per model step of each smoke model: phi4 7 a layer x 2 + the
#: logits; rwkv6 10 a layer (r, k, v, g, the two decay LoRA factors, o, and
#: the channel mix's three) x 2 + 1; zamba2 2 a Mamba2 layer x 4 + 8 a shared
#: block application (down, q, k, v, o, and the MLP's three) x 2 + 1
GEMMS_PER_STEP = {"phi4-mini-3.8b": 15, "rwkv6-1.6b": 21, "zamba2-2.7b": 25}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if tree.dtype == jnp.bfloat16:
        return np.asarray(tree.astype(jnp.float32))
    return np.asarray(tree)


@pytest.fixture(scope="module", params=sorted(GEMMS_PER_STEP))
def pair(request):
    jcfg = j_get_config(request.param, smoke=True)
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = get_config(request.param, smoke=True)
    tparams = params_from_numpy(
        _np_tree(jparams), model_api(tcfg, device="cpu").param_specs(), "cpu")
    return jcfg, jparams, tcfg, tparams


def _assert_same_or_tied(got, want, logits_at, what):
    """``got`` equals ``want``, or at the first step where they part
    ``got``'s token is among the reference's tied largest logits.
    ``logits_at(i)`` gives the reference's logits (1-D numpy) at step ``i``
    after ``want[:i]``."""
    assert len(got) == len(want), what
    if got == want:
        return
    i = next(k for k, (g, w) in enumerate(zip(got, want)) if g != w)
    lg = np.asarray(logits_at(i), np.float32)
    assert int(lg.argmax()) == want[i], what
    tied = lg >= lg.max() - 2 * BF16_TOL * np.abs(lg).max()
    assert tied[got[i]], (what, i, got[i], want[i],
                          float(lg.max() - lg[got[i]]))


def test_tie_rule_accepts_only_tied_tokens():
    lg = np.array([1.0, 0.99, 0.5, -1.0], np.float32)
    _assert_same_or_tied([0, 3], [0, 3], None, "equal")
    _assert_same_or_tied([1, 3], [0, 2], lambda i: lg, "tied at step 0")
    with pytest.raises(AssertionError):
        _assert_same_or_tied([2, 3], [0, 3], lambda i: lg, "not tied")
    with pytest.raises(AssertionError):
        _assert_same_or_tied([0], [0, 3], lambda i: lg, "lengths")


def _jax_logits_alone(api, params, prompt, fed, max_len):
    """The JAX model's logits after ``prompt`` and then ``fed``, one request
    alone; an ssm/hybrid prompt is absorbed by decode steps, as the JAX
    engine absorbs it."""
    step = jax.jit(api.decode_step)
    if api.cfg.family in ("ssm", "hybrid"):
        state = api.make_decode_state(JShape("serve", max_len, 1, "decode"))
        for t in prompt:
            logits, state = step(params, state, jnp.asarray([[t]]))
    else:
        logits, state = api.prefill(params, {"tokens": jnp.asarray([prompt])},
                                    max_len=max_len)
    for t in fed:
        logits, state = step(params, state, jnp.asarray([[t]]))
    return np.asarray(logits)[0]


def _requests(cls):
    return [cls(uid=i, prompt=list(p), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))]


class ManualClock:
    """Virtual time that moves only when the test moves it."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _drain_in_virtual_time(eng, reqs, clock, step_cost_s=0.02):
    for r in reqs:
        eng.submit(r)
    while not eng.scheduler.drained():
        used = eng.step()
        clock.now += step_cost_s * used
    return eng.run_until_drained()


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_engine_matches_jax_engine(pair, backend):
    jcfg, jparams, tcfg, tparams = pair
    jclock, tclock = ManualClock(), ManualClock()
    jeng = JServeEngine(jcfg, jparams, slots=2, max_len=32, backend=backend,
                        clock=jclock, obs=JObsBus(clock=jclock))
    teng = ServeEngine(tcfg, tparams, slots=2, max_len=32, backend=backend,
                       clock=tclock, obs=ObsBus(clock=tclock), device="cpu")
    jreqs, treqs = _requests(JRequest), _requests(Request)
    jstats = _drain_in_virtual_time(jeng, jreqs, jclock)
    tstats = _drain_in_virtual_time(teng, treqs, tclock)
    japi = j_model_api(jcfg, backend=backend)
    for jr, tr in zip(jreqs, treqs):
        _assert_same_or_tied(
            tr.out_tokens, jr.out_tokens,
            lambda i: _jax_logits_alone(japi, jparams, jr.prompt,
                                        jr.out_tokens[:i], 32), tr.uid)
        assert len(tr.out_tokens) == tr.max_new_tokens and not tr.truncated
    jd, td = jstats.to_dict(), tstats.to_dict()
    assert list(jd) == list(td)                        # same keys, same order
    # under the manual clock even the clock's fields agree
    assert td == jd
    assert {k: v for k, v in td.items() if k not in CLOCK_FIELDS} == \
        {k: v for k, v in jd.items() if k not in CLOCK_FIELDS}
    if backend == "reference":
        bt = td["backend_telemetry"]
        assert bt["calls"] == GEMMS_PER_STEP[tcfg.name] * tstats.model_steps
        assert (bt["calls"], bt["macs"], bt["flags"]) == tuple(
            jd["backend_telemetry"][k] for k in ("calls", "macs", "flags"))
        assert bt["flags"] == 0
        assert td["backend_step_flags"] == [[]] * tstats.decode_steps
    else:
        assert td["backend_telemetry"] is None
    # metric renders: byte for byte the JAX engine's
    assert teng.obs.render_prometheus() == jeng.obs.render_prometheus()
    assert teng.obs.render_json() == jeng.obs.render_json()


def test_two_virtual_time_runs_render_identically(pair):
    *_, tcfg, tparams = pair

    def one(seed_shift=0):
        clock = ManualClock()
        eng = ServeEngine(tcfg, tparams, slots=2, max_len=32,
                          backend="reference", clock=clock,
                          obs=ObsBus(clock=clock), device="cpu")
        reqs = _requests(Request)[seed_shift:]
        _drain_in_virtual_time(eng, reqs, clock)
        return eng.obs.render_prometheus()

    text = one()
    assert text == one()
    assert "serve_ttft_seconds" in text and "backend_macs_total" in text
    assert text != one(1)              # the render does depend on the run


def _alone(api, params, prompt, max_new, max_len):
    """Greedy decode of one request alone (the slots=1 ground truth): the
    tokens and each step's logits.  An ssm/hybrid prompt is absorbed by
    decode steps."""
    if api.cfg.family in ("ssm", "hybrid"):
        state = api.make_decode_state(ShapeConfig("serve", max_len, 1,
                                                  "decode"))
        for t in prompt:
            logits, state = api.decode_step(params, state,
                                            torch.tensor([[t]]))
    else:
        logits, state = api.prefill(params, {"tokens": torch.tensor([prompt])},
                                    max_len=max_len)
    out, steps = [int(logits[0].argmax())], [logits[0].numpy()]
    while len(out) < max_new:
        logits, state = api.decode_step(params, state,
                                        torch.tensor([[out[-1]]]))
        out.append(int(logits[0].argmax()))
        steps.append(logits[0].numpy())
    return out, steps


@pytest.mark.parametrize("backend", [None, "reference"])
def test_outputs_equal_a_one_slot_decode(pair, backend):
    *_, tcfg, tparams = pair
    eng = ServeEngine(tcfg, tparams, slots=3, max_len=32, backend=backend,
                      device="cpu")
    reqs = _requests(Request)
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats.completed == len(reqs) and stats.truncated == 0
    api = model_api(tcfg, backend=backend, device="cpu")
    alone = [_alone(api, tparams, r.prompt, r.max_new_tokens, 32)
             for r in reqs]
    for r, (toks, steps) in zip(reqs, alone):
        _assert_same_or_tied(r.out_tokens, toks, steps.__getitem__, r.uid)
    one = ServeEngine(tcfg, tparams, slots=1, max_len=32, backend=backend,
                      device="cpu")
    again = _requests(Request)
    for r in again:
        one.submit(r)
    one.run_until_drained()
    for r, (toks, steps) in zip(again, alone):
        _assert_same_or_tied(r.out_tokens, toks, steps.__getitem__, r.uid)


def test_fewer_model_steps_than_wave_engine(pair):
    *_, tcfg, tparams = pair
    cont = ServeEngine(tcfg, tparams, slots=2, max_len=32, device="cpu")
    wave = WaveServeEngine(tcfg, tparams, slots=2, max_len=32, device="cpu")
    for eng in (cont, wave):
        for r in _requests(Request):
            eng.submit(r)
    cs, ws = cont.run_until_drained(), wave.run_until_drained()
    assert cs.completed == ws.completed == len(PROMPTS)
    assert cs.tokens_generated == ws.tokens_generated == sum(MAX_NEW)
    assert cs.model_steps < ws.model_steps
    assert ws.waves == 3


def test_truncation_is_reported_and_idle_slots_run_past_the_cache(pair):
    *_, tcfg, tparams = pair
    eng = ServeEngine(tcfg, tparams, slots=2, max_len=8, device="cpu")
    short = Request(uid=0, prompt=[5, 6], max_new_tokens=2)
    long = Request(uid=1, prompt=[7], max_new_tokens=50)     # cut at max_len
    huge = Request(uid=2, prompt=list(range(3, 20)), max_new_tokens=2)
    for r in (short, long, huge):
        eng.submit(r)
    stats = eng.run_until_drained()
    assert short.done and not short.truncated
    assert long.truncated and len(long.out_tokens) == 7
    assert huge.truncated and huge.out_tokens == []
    assert (stats.completed, stats.truncated) == (1, 2)
    # slot 0 sat idle, fed BOS, while `long` ran on: its index passed the
    # cache's end and the writes were dropped, not faulted
    assert int(eng._state["index"].max()) >= 8


def test_stats_view_agrees_with_registry(pair):
    *_, tcfg, tparams = pair
    eng = ServeEngine(tcfg, tparams, slots=2, max_len=32, device="cpu")
    for r in _requests(Request):
        eng.submit(r)
    stats = eng.run_until_drained()
    assert isinstance(stats, EngineStats)
    text = eng.obs.render_prometheus()
    assert f"serve_tokens_generated_total {float(sum(MAX_NEW))}" in text \
        or f"serve_tokens_generated_total {sum(MAX_NEW)}" in text
    assert stats.tokens_generated == sum(MAX_NEW)
    assert stats.to_dict()["model_steps"] == stats.prefill_steps + \
        stats.decode_steps


#: the encoder-decoder family: a prompt is absorbed by one prefill that also
#: encodes the request's frames (zeros of max_len // enc_frames_ratio where
#: it carries none)
ENCDEC = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def encdec_pair():
    jcfg = j_get_config(ENCDEC, smoke=True)
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = get_config(ENCDEC, smoke=True)
    tparams = params_from_numpy(
        _np_tree(jparams), model_api(tcfg, device="cpu").param_specs(), "cpu")
    return jcfg, jparams, tcfg, tparams


def _request_frames(cfg, uid, max_len):
    """Seeded nonzero frames of one request, (1, t_enc, d) float32."""
    return np.random.default_rng(100 + uid).standard_normal(
        (1, max_len // cfg.enc_frames_ratio, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("with_frames", [False, True],
                         ids=["zero_frames", "request_frames"])
def test_encdec_engine_matches_jax_engine_and_one_slot_decode(
        encdec_pair, with_frames):
    """A seamless smoke engine (2 slots, max_len 32, ``reference``) drains
    the reference's requests, with and without ``Request.frames``: tokens
    equal to the JAX engine's (C1 tie rule) and to the port's one-slot
    decode of each request alone; every other stat and the backends'
    telemetry equal."""
    jcfg, jparams, tcfg, tparams = encdec_pair
    max_len = 32
    jclock, tclock = ManualClock(), ManualClock()
    jeng = JServeEngine(jcfg, jparams, slots=2, max_len=max_len,
                        backend="reference", clock=jclock,
                        obs=JObsBus(clock=jclock))
    teng = ServeEngine(tcfg, tparams, slots=2, max_len=max_len,
                       backend="reference", clock=tclock,
                       obs=ObsBus(clock=tclock), device="cpu")
    jreqs, treqs = _requests(JRequest), _requests(Request)
    frames = [_request_frames(tcfg, r.uid, max_len) if with_frames else None
              for r in treqs]
    for jr, tr, fr in zip(jreqs, treqs, frames):
        jr.frames, tr.frames = fr, fr
    jstats = _drain_in_virtual_time(jeng, jreqs, jclock)
    tstats = _drain_in_virtual_time(teng, treqs, tclock)
    japi = j_model_api(jcfg)
    tapi = model_api(tcfg, backend="reference", device="cpu")
    zeros = np.zeros((1, max_len // tcfg.enc_frames_ratio, tcfg.d_model),
                     np.float32)

    def jax_logits(prompt, fr, fed):
        step = jax.jit(japi.decode_step)
        logits, state = japi.prefill(
            jparams, {"tokens": jnp.asarray([prompt]),
                      "frames": jnp.asarray(fr).astype(jnp.bfloat16)},
            max_len=max_len)
        for t in fed:
            logits, state = step(jparams, state, jnp.asarray([[t]]))
        return np.asarray(logits)[0]

    for jr, tr, fr in zip(jreqs, treqs, frames):
        fr = zeros if fr is None else fr
        _assert_same_or_tied(
            tr.out_tokens, jr.out_tokens,
            lambda i: jax_logits(jr.prompt, fr, jr.out_tokens[:i]), tr.uid)
        assert len(tr.out_tokens) == tr.max_new_tokens and not tr.truncated
        # the port's one-slot decode of the request alone
        logits, state = tapi.prefill(
            tparams, {"tokens": torch.tensor([tr.prompt]),
                      "frames": torch.from_numpy(fr)}, max_len=max_len)
        out, steps = [int(logits[0].argmax())], [logits[0].numpy()]
        while len(out) < tr.max_new_tokens:
            logits, state = tapi.decode_step(tparams, state,
                                             torch.tensor([[out[-1]]]))
            out.append(int(logits[0].argmax()))
            steps.append(logits[0].numpy())
        _assert_same_or_tied(tr.out_tokens, out, steps.__getitem__, tr.uid)
    jd, td = jstats.to_dict(), tstats.to_dict()
    jtel = without_self_kv(jd.pop("backend_telemetry"), tcfg,
                           jstats.prefill_steps,
                           sum(len(r.prompt) for r in jreqs))
    assert td.pop("backend_telemetry") == jtel
    assert td == jd
    assert jtel["flags"] == 0
    # every series equal but the per-GEMM callback histogram, which counts
    # the prefills' GEMMs too
    assert _series_but_callbacks(teng) == _series_but_callbacks(jeng)
    assert teng.obs.render_json()["backend_callback_seconds"]["values"][0][
        "count"] == jtel["calls"]


def _series_but_callbacks(engine):
    return [line for line in engine.obs.render_prometheus().splitlines()
            if not line.startswith("backend_callback_seconds")]


def test_launcher_writes_the_jax_launchers_json(tmp_path, monkeypatch, capsys):
    flags = ["--arch", "phi4-mini-3.8b", "--smoke", "--backend", "reference",
             "--requests", "3", "--slots", "2", "--max-new", "3"]
    t_out, j_out = tmp_path / "torch.json", tmp_path / "jax.json"
    t_launch.main(flags + ["--device", "cpu", "--json-out", str(t_out),
                           "--metrics", str(tmp_path / "m.prom")])
    monkeypatch.setattr(sys, "argv", ["serve"] + flags
                        + ["--json-out", str(j_out)])
    j_launch.main()
    capsys.readouterr()
    t, j = json.loads(t_out.read_text()), json.loads(j_out.read_text())
    assert list(t) == list(j)
    # same workload (numpy-made prompts), same accounting; the weights come
    # from each framework's own generator, so the tokens are not compared
    for key in ("arch", "engine", "slots", "max_len", "requests",
                "prefill_steps", "decode_steps", "admitted", "completed",
                "truncated", "tokens_generated", "slot_busy_steps", "backend",
                "model_steps", "occupancy"):
        assert t[key] == j[key], key
    assert t["backend_telemetry"] == j["backend_telemetry"]
    assert "serve_decode_steps_total" in (tmp_path / "m.prom").read_text()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_launcher_serves_the_ssm_archs_as_the_jax_launcher(
        arch, backend, tmp_path, monkeypatch, capsys):
    flags = ["--arch", arch, "--smoke", "--backend", backend, "--requests",
             "3", "--slots", "2", "--max-new", "3", "--mixed"]
    t_out, j_out = tmp_path / "torch.json", tmp_path / "jax.json"
    t_launch.main(flags + ["--device", "cpu", "--json-out", str(t_out)])
    monkeypatch.setattr(sys, "argv", ["serve"] + flags
                        + ["--json-out", str(j_out)])
    j_launch.main()
    capsys.readouterr()
    t, j = json.loads(t_out.read_text()), json.loads(j_out.read_text())
    assert list(t) == list(j)
    for key in ("arch", "engine", "slots", "max_len", "requests",
                "prefill_steps", "decode_steps", "admitted", "completed",
                "truncated", "tokens_generated", "slot_busy_steps", "backend",
                "model_steps", "occupancy"):
        assert t[key] == j[key], key
    assert t["prefill_steps"] > 0 and t["completed"] == 3
    assert t["backend_telemetry"] == j["backend_telemetry"]


@pytest.mark.parametrize("arch", [ENCDEC, "llama4-scout-17b-a16e",
                                  "grok-1-314b", "llava-next-mistral-7b"])
@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_launcher_serves_the_other_families_as_the_jax_launcher(
        arch, backend, tmp_path, monkeypatch, capsys):
    """The encdec, moe and vlm archs at ``--smoke`` through both launchers:
    the same accounting and, under ``reference``, the same GEMM calls and
    MACs (the weights come from each framework's own generator) but, for
    seamless, the two a decoder layer that the JAX prefill spends
    projecting the prompt's self-attention K/V again."""
    flags = ["--arch", arch, "--smoke", "--backend", backend, "--requests",
             "3", "--slots", "2", "--max-new", "3", "--mixed"]
    t_out, j_out = tmp_path / "torch.json", tmp_path / "jax.json"
    t_launch.main(flags + ["--device", "cpu", "--json-out", str(t_out)])
    monkeypatch.setattr(sys, "argv", ["serve"] + flags
                        + ["--json-out", str(j_out)])
    j_launch.main()
    capsys.readouterr()
    t, j = json.loads(t_out.read_text()), json.loads(j_out.read_text())
    assert list(t) == list(j)
    for key in ("arch", "engine", "slots", "max_len", "requests",
                "prefill_steps", "decode_steps", "admitted", "completed",
                "truncated", "tokens_generated", "slot_busy_steps", "backend",
                "model_steps", "occupancy"):
        assert t[key] == j[key], key
    assert t["prefill_steps"] == 3 and t["completed"] == 3
    jtel = j["backend_telemetry"]
    if arch == ENCDEC and backend == "reference":
        cfg = get_config(arch, smoke=True)
        prompts = t_launch.make_requests(cfg, 3, 3, True, 0)
        jtel = without_self_kv(jtel, cfg, t["prefill_steps"],
                               sum(len(r.prompt) for r in prompts))
    assert t["backend_telemetry"] == jtel


@pytest.mark.parametrize("flags", [
    ["--backend", "emulated", "--guard", "abft"],
    ["--backend", "emulated", "--autoscale", "pid"]],
    ids=["guard", "autoscale"])
def test_launcher_runs_guarded_and_autoscaled_as_the_jax_launcher(
        flags, tmp_path, monkeypatch, capsys):
    base = ["--arch", "phi4-mini-3.8b", "--smoke", "--requests", "3",
            "--slots", "2", "--max-new", "3"] + flags
    t_out, j_out = tmp_path / "torch.json", tmp_path / "jax.json"
    t_launch.main(base + ["--device", "cpu", "--json-out", str(t_out)])
    t_print = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + base
                        + ["--json-out", str(j_out)])
    j_launch.main()
    j_print = capsys.readouterr().out
    t, j = json.loads(t_out.read_text()), json.loads(j_out.read_text())
    assert list(t) == list(j)
    # everything but the wall clock: the guard's and the autoscaler's
    # telemetry included (the weights come from each framework's own
    # generator, so the tokens are not compared)
    for key in j:
        if key not in ("wall_s", "tok_per_s", "ttft_s", "ttft_mean_s"):
            assert t[key] == j[key], key
    if "--guard" in flags:
        bt = t["backend_telemetry"]
        assert bt["backend"] == "guarded[emulated]"
        assert bt["guard_checks"] == bt["calls"] > 0
        assert bt["energy_per_token_j"] > 0
    else:
        assert t["railscale"]["policy"] == "pid"
        assert t["railscale"]["decisions"] > 0
    for tag in ("[backend:", "[hwloop]", "[railscale:"):
        assert (tag in t_print) == (tag in j_print), tag
    railscale = [ln for ln in t_print.splitlines() if ln.startswith(
        "[railscale:")]
    assert railscale == [ln for ln in j_print.splitlines()
                         if ln.startswith("[railscale:")]


@pytest.mark.parametrize("flags,what", [
    (["--guard", "abft"], "--guard needs a non-ideal --backend"),
    (["--autoscale", "threshold"], "pass --backend emulated"),
    (["--autoscale", "pid", "--backend", "emulated", "--engine", "wave"],
     "require the continuous engine"),
    (["--serve-http", "127.0.0.1:0", "--trace", "t.ndjson"],
     "--serve-http and --trace are mutually exclusive"),
    (["--trace", "t.ndjson", "--engine", "wave"],
     "--backend/--hwloop/--serve-http/--trace/--policy/--max-pending require "
     "the continuous engine")])
def test_launcher_refuses_what_the_jax_launcher_refuses(flags, what, capsys):
    with pytest.raises(SystemExit) as exc:
        t_launch.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device",
                       "cpu"] + flags)
    assert exc.value.code == 2
    assert what in capsys.readouterr().err
