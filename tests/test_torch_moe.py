"""The MoE and VLM families of the port against the JAX package's, on the
CPU: grok-1-314b (top-2 routing, experts replicated), llama4-scout-17b-a16e
(top-1 routing plus the shared expert, experts over the model axis) and
llava-next-mistral-7b (patch embeddings in front of the tokens, a sliding
window) at smoke size, from the JAX package's own initial weights converted
leaf by leaf.

Tolerances are those of ``tests/test_torch_models.py``: ``BF16_TOL`` of the
reference's largest magnitude on layer outputs, logits and states; router
probabilities within 1e-6 (two f32 softmaxes of the same f32 product);
converted trees, router indices and state surgery exact.  The end-to-end
steps are held against the reference run op by op (``jax.disable_jit()``,
ROADMAP C7) on its ``ideal`` backend, with the reference's tokens fed to
both stacks and the port's arg-max held to the C1 tie rule; the
reference's ``reference`` backend runs compiled only (its host callback
dispatches JAX operations, which can deadlock against op-by-op dispatch),
for its GEMM telemetry.

A routing decision is only as firm as its margin: where the k-th and the
next expert's router logits lie closer than the two stacks' rounding noise
(bf16 activations that differ in a last bit), a token goes to another expert
and its output moves by O(1).  ``PROMPT_SEED`` picks prompts whose every
routing decision, in the reference, keeps the chosen experts at least
``ROUTER_MARGIN`` above the rest in log-probability, and the tests assert
that margin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import model_api as j_model_api
from repro_torch.backend import get_backend, use_backend
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import (decode_state_from_numpy, layers, lm,
                                model_api, param_count, params_from_numpy)
from test_torch_models import BF16_TOL, _close, _np_tree

MOE_ARCHS = ("grok-1-314b", "llama4-scout-17b-a16e")
VLM_ARCH = "llava-next-mistral-7b"
#: log-probability gap between the last chosen expert and the first left
#: out, below which a decision is a near-tie (the stacks' router logits
#: differ by about 1e-3 on these smoke models)
ROUTER_MARGIN = 0.05
#: the same where both stacks route the same bf16 input: their f32 router
#: products then differ by summation order alone (about 1e-7 relative)
LAYER_MARGIN = 1e-4
#: prompt seeds whose routing decisions all keep ROUTER_MARGIN in the
#: reference's op-by-op prefill and eight decode steps (the widest minimum
#: among 40 seeds tried; llava has no router and takes seed 0)
PROMPT_SEED = {"grok-1-314b": 0, "llama4-scout-17b-a16e": 36,
               VLM_ARCH: 0}


def _pair(arch):
    jcfg = j_get_config(arch, smoke=True)
    japi = j_model_api(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    tcfg = get_config(arch, smoke=True)
    tapi = model_api(tcfg, device="cpu")
    tparams = params_from_numpy(_np_tree(jparams), tapi.param_specs(), "cpu")
    return jcfg, japi, jparams, tcfg, tapi, tparams


@pytest.fixture(scope="module", params=MOE_ARCHS + (VLM_ARCH,))
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    return _pair(request.param)


def _layer0(params, key):
    return {k: v[0] for k, v in params["blocks"][key].items()}


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


def _margins(probs, k):
    """Per row, log p of the k-th expert minus log p of the (k+1)-th."""
    lg = np.sort(np.log(np.asarray(probs, np.float64)), axis=-1)[:, ::-1]
    return lg[:, k - 1] - lg[:, k]


def test_configs_equal_and_converted_tree_is_exact(pair):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    specs = tapi.param_specs()
    assert param_count(specs) == param_count(tparams) == sum(
        x.size for x in jax.tree.leaves(jparams))

    def check(jt, tt, st):
        if isinstance(jt, dict):
            assert sorted(jt) == sorted(tt) == sorted(st)
            for k in jt:
                check(jt[k], tt[k], st[k])
            return
        assert tt.dtype == st.dtype and tuple(tt.shape) == jt.shape
        assert str(jt.dtype) == str(tt.dtype).replace("torch.", "")
        assert np.array_equal(tt.to(torch.float32).numpy(),
                              np.asarray(jt.astype(jnp.float32)))
    check(jparams, tparams, specs)


@pytest.mark.parametrize("shard", ["expert", "ffn"])
def test_moe_spec_trees_match_the_references(shard):
    """Both ``moe_shard`` layouts: the same leaves, shapes, dtypes and
    logical axes as ``repro.models.layers.moe_param_specs``."""
    jcfg, tcfg = (dataclasses.replace(c, moe_shard=shard) for c in (
        j_get_config("grok-1-314b", smoke=True),
        get_config("grok-1-314b", smoke=True)))
    jspec, tspec = jlayers.moe_param_specs(jcfg), layers.moe_param_specs(tcfg)
    assert sorted(jspec) == sorted(tspec) == ["router", "w1", "w2", "wg"]
    for key in jspec:
        assert tspec[key].shape == jspec[key].shape
        assert tspec[key].logical == jspec[key].logical
        assert tspec[key].init == jspec[key].init
        assert str(tspec[key].dtype).replace("torch.", "") == \
            jnp.dtype(jspec[key].dtype).name
    assert tspec["w1"].logical[1] == ("expert" if shard == "expert" else None)


def test_init_params_scales_and_dtypes(moe_pair):
    *_, tcfg, tapi, _ = moe_pair
    p = tapi.init_params(seed=3)
    m = p["blocks"]["moe"]
    assert m["router"].dtype == torch.float32
    assert m["w1"].dtype == m["wg"].dtype == m["w2"].dtype == torch.bfloat16
    assert tuple(m["w1"].shape) == (tcfg.n_layers, tcfg.n_experts,
                                    tcfg.d_model, tcfg.d_ff)
    for key, fan_in in (("router", tcfg.d_model), ("w1", tcfg.d_model),
                        ("w2", tcfg.d_ff)):
        std = float(m[key].to(torch.float32).std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, key
    assert ("mlp" in p["blocks"]) == tcfg.shared_expert


def test_router(moe_pair):
    jcfg, _, jparams, tcfg, _, tparams = moe_pair
    jx, tx = _x(jcfg, 1, 24, seed=7)
    jw, jidx, jprobs = jlayers._router(jx.reshape(24, -1),
                                       _layer0(jparams, "moe"), jcfg)
    tw, tidx, tprobs = layers._router(tx.reshape(24, -1),
                                      _layer0(tparams, "moe"), tcfg)
    assert _margins(jprobs, jcfg.top_k).min() > LAYER_MARGIN
    assert tidx.dtype == torch.int64
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_tied_probabilities_keep_the_lower_expert_first(top_k):
    """Exactly tied router probabilities: ``jax.lax.top_k`` puts the lower
    expert first, and so must the port (``torch.topk`` promises no order).
    Experts 1, 2 and 4 have zero router columns, so their logits are 0 and
    their probabilities equal; the other three lie below."""
    jcfg, tcfg = (dataclasses.replace(c, n_experts=6, top_k=top_k) for c in (
        j_get_config("grok-1-314b", smoke=True),
        get_config("grok-1-314b", smoke=True)))
    rng = np.random.default_rng(11)
    d = jcfg.d_model
    router = -np.abs(rng.standard_normal((d, 6))).astype(np.float32) / d
    router[:, [1, 2, 4]] = 0.0
    x = np.abs(rng.standard_normal((5, d))).astype(np.float32)
    jw, jidx, _ = jlayers._router(jnp.asarray(x),
                                  {"router": jnp.asarray(router)}, jcfg)
    tw, tidx, tprobs = layers._router(torch.from_numpy(x),
                                      {"router": torch.from_numpy(router)},
                                      tcfg)
    probs = tprobs.numpy()
    assert (probs[:, 1] == probs[:, 2]).all() and \
        (probs[:, 2] == probs[:, 4]).all()
    assert (probs[:, [0, 3, 5]] < probs[:, [1]]).all()
    assert np.array_equal(np.asarray(jidx), np.tile([1, 2, 4][:top_k],
                                                    (5, 1)))
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), 1.0 / top_k, rtol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_moe_dense(moe_pair, backend):
    """Both branches: one einsum over all experts (``ideal``) and E GEMMs an
    up/gate/down product through a host backend (``reference``); the gated
    combine sums the experts in f32 and rounds once."""
    jcfg, _, jparams, tcfg, _, tparams = moe_pair
    jx, tx = _x(jcfg, 2, 5, seed=8)
    jw, _, jprobs = jlayers._router(jx.reshape(10, -1),
                                    _layer0(jparams, "moe"), jcfg)
    assert _margins(jprobs, jcfg.top_k).min() > LAYER_MARGIN
    from repro.backend import get_backend as j_get_backend
    from repro.backend import use_backend as j_use_backend
    jbe, tbe = j_get_backend(backend), get_backend(backend, device="cpu")
    with j_use_backend(jbe):
        # compiled: the reference backend's host callback dispatches JAX
        # operations, which can deadlock against eager dispatch
        want = jax.jit(lambda x, p: jlayers.moe_dense(x, p, jcfg))(
            jx, _layer0(jparams, "moe"))
    with use_backend(tbe), torch.inference_mode():
        got = layers.moe(tx, _layer0(tparams, "moe"), tcfg)
    assert got.dtype == torch.bfloat16
    _close(got, want)
    if backend == "reference":
        per_expert = 3 if tcfg.act == "swiglu" else 2
        assert tbe.summary()["calls"] == 1 + per_expert * tcfg.n_experts
        assert tbe.summary() == jbe.summary()


def test_ep_a2a_is_refused_naming_its_roadmap_item(moe_pair):
    """``moe_impl="ep_a2a"`` (ported with the mesh, ROADMAP A14; the mesh
    runs are in ``test_torch_mesh.py``) without a mesh is the dense
    dispatch, as the reference's fallback: the same bits as
    ``moe_dense``, and the reference's ``moe`` on ``ideal``."""
    jcfg, _, jparams, tcfg, _, tparams = moe_pair
    cfg = dataclasses.replace(tcfg, moe_impl="ep_a2a")
    jx, tx = _x(cfg, 1, 4, seed=9)
    with torch.inference_mode():
        got = layers.moe(tx, _layer0(tparams, "moe"), cfg)
        assert torch.equal(got, layers.moe_dense(tx, _layer0(tparams, "moe"),
                                                 cfg))
    with jax.disable_jit():
        want = jlayers.moe(jx, _layer0(jparams, "moe"),
                           dataclasses.replace(jcfg, moe_impl="ep_a2a"))
    _close(got, want)


def _record_routes(module, sink):
    """A ``_router`` that appends each call's (indices, probs) to ``sink``."""
    inner = module._router

    def router(x, p, cfg):
        w, idx, probs = inner(x, p, cfg)
        sink.append((np.asarray(idx), np.asarray(probs, np.float64)))
        return w, idx, probs
    return router


def _compiled_reference_summary(jcfg, jparams, batch, fed, max_len):
    """The JAX package's ``reference`` backend telemetry over a compiled
    prefill of ``batch`` and one compiled decode step a token column of
    ``fed``.  Compiled, because that backend's host callback dispatches JAX
    operations, which can deadlock against a computation run op by op."""
    japi = j_model_api(jcfg, backend="reference")
    _, state = jax.jit(lambda p, b: japi.prefill(p, b, max_len=max_len))(
        jparams, batch)
    step = jax.jit(japi.decode_step)
    for tok in fed:
        _, state = step(jparams, state, jnp.asarray(tok))
    return japi.backend.summary()


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_prefill_and_eight_decode_steps(pair, backend, monkeypatch):
    """Prefill logits and eight decode steps against the reference run op by
    op (on its ``ideal`` backend, whose GEMMs the port's ``reference`` one
    computes at nominal rails): logits within BF16_TOL, the same experts at
    every routing decision (each with ROUTER_MARGIN in the reference), the
    port's arg-max the reference's or tied with it (C1), and the final cache
    within BF16_TOL.  Under ``reference`` the port's backend counts the
    GEMMs, MACs and flags of the reference's compiled ``reference`` run."""
    jcfg, japi, jparams, tcfg, _, tparams = pair
    tapi = model_api(tcfg, backend=backend, device="cpu")
    jroutes, troutes = [], []
    monkeypatch.setattr(jlayers, "_router", _record_routes(jlayers, jroutes))
    monkeypatch.setattr(layers, "_router", _record_routes(layers, troutes))
    toks = np.random.default_rng(PROMPT_SEED[jcfg.name]).integers(
        3, jcfg.vocab_size, (2, 6))
    with jax.disable_jit():
        jlog, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                    max_len=16)
    tlog, tstate = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                max_len=16)
    assert tlog.dtype == torch.float32
    assert tuple(tlog.shape) == (2, tcfg.padded_vocab)
    fed = []
    for step in range(9):
        _close(tlog, jlog)
        jl = np.asarray(jlog, np.float32)
        jtok = jl.argmax(-1)
        for row, t in enumerate(tlog.argmax(-1).numpy()):
            assert t == jtok[row] or jl[row, t] >= jl[row].max() - (
                2 * BF16_TOL * np.abs(jl[row]).max()), (step, row)
        if step == 8:
            break
        fed.append(jtok[:, None])
        with jax.disable_jit():
            jlog, jstate = japi.decode_step(jparams, jstate,
                                            jnp.asarray(fed[-1]))
        tlog, tstate = tapi.decode_step(tparams, tstate,
                                        torch.from_numpy(fed[-1]))
    calls = jcfg.n_layers * 9 if jcfg.n_experts else 0
    assert len(jroutes) == len(troutes) == calls
    for (ji, jp), (ti, tp) in zip(jroutes, troutes):
        assert _margins(jp, jcfg.top_k).min() > ROUTER_MARGIN
        assert np.array_equal(ti, ji)
    assert np.array_equal(tstate["index"].numpy(), np.asarray(jstate["index"]))
    _close(tstate["kv"]["k"], jstate["kv"]["k"])
    _close(tstate["kv"]["v"], jstate["kv"]["v"])
    if backend == "reference":
        per_layer = 7
        if tcfg.n_experts:
            per_layer = 5 + 3 * tcfg.n_experts + 3 * tcfg.shared_expert
        assert tapi.backend.summary()["calls"] == 9 * (
            per_layer * tcfg.n_layers + 1)
        monkeypatch.undo()                    # no recording while tracing
        assert tapi.backend.summary() == _compiled_reference_summary(
            jcfg, jparams, {"tokens": jnp.asarray(toks)}, fed, 16)


def test_loss_matches_jax(moe_pair):
    """``ModelAPI.loss`` through the MoE blocks, within 5e-3 relative of the
    reference's (compiled) loss, as ``test_torch_models.py`` holds the
    dense family's."""
    jcfg, japi, jparams, tcfg, tapi, tparams = moe_pair
    rng = np.random.default_rng(21)
    toks = rng.integers(3, jcfg.vocab_size, (2, 32))
    labels = rng.integers(3, jcfg.vocab_size, (2, 32))
    want = float(japi.loss(jparams, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)}))
    got = tapi.loss(tparams, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 5e-3 * abs(want), (float(got), want)


def test_decode_state_round_trip_and_slot_surgery(pair):
    """The decoder LM's state for these families: the same leaves as the
    reference's, and per-slot slice / update / reset as the reference's."""
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jshape, tshape = (JShape("s", 8, 3, "decode"),
                      ShapeConfig("s", 8, 3, "decode"))
    rng = np.random.default_rng(9)
    jstate = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 4).astype(
            x.dtype), japi.make_decode_state(jshape))
    tstate = decode_state_from_numpy(_np_tree(jstate),
                                     tapi.decode_state_specs(tshape), "cpu")
    sub_specs = tapi.decode_state_specs(ShapeConfig("s", 8, 1, "decode"))
    jsub = japi.slot_slice(jshape, jstate, 1)
    tsub = tapi.slot_slice(tshape, tstate, 1)
    fresh = jax.tree.map(lambda x: x + 1, jsub)
    jstate = japi.slot_update(jshape, jstate, 2, fresh)
    tapi.slot_update(tshape, tstate, 2, decode_state_from_numpy(
        _np_tree(fresh), sub_specs, "cpu"))
    jstate = japi.slot_reset(jshape, jstate, 0)
    tapi.slot_reset(tshape, tstate, 0)
    for want, got in ((jsub, tsub), (jstate, tstate)):
        for key in ("k", "v"):
            assert np.array_equal(got["kv"][key].to(torch.float32).numpy(),
                                  np.asarray(want["kv"][key].astype(
                                      jnp.float32)))
        assert got["index"].tolist() == np.asarray(want["index"]).tolist()


# ---------------------------------------------------------------------------
# llava-next-mistral-7b: patch embeddings in front of the tokens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vlm_pair():
    return _pair(VLM_ARCH)


def _patches(cfg, b, p, seed):
    pe = np.random.default_rng(seed).standard_normal(
        (b, p, cfg.d_model)).astype(np.float32)
    return jnp.asarray(pe).astype(jnp.bfloat16), torch.from_numpy(pe)


def test_vlm_loss_drops_the_patch_positions(vlm_pair):
    """``loss`` with ``patch_embeds`` (the smoke config's 8 patches in front
    of 24 tokens): within 5e-3 relative of the reference's, and the loss of
    the tokens alone only (the patches' positions carry none)."""
    jcfg, japi, jparams, tcfg, tapi, tparams = vlm_pair
    rng = np.random.default_rng(22)
    toks = rng.integers(3, jcfg.vocab_size, (2, 24))
    labels = rng.integers(3, jcfg.vocab_size, (2, 24))
    jpe, tpe = _patches(jcfg, 2, jcfg.frontend_tokens, seed=23)
    want = float(japi.loss(jparams, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels),
                                     "patch_embeds": jpe}))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels), "patch_embeds": tpe}
    got = float(tapi.loss(tparams, batch))
    assert abs(got - want) <= 5e-3 * abs(want), (got, want)
    # by hand: the backbone over [patches, tokens], the loss of the tokens
    with torch.inference_mode():
        x = torch.cat([tpe.to(torch.bfloat16),
                       layers.embed(batch["tokens"], tparams)], dim=1)
        y = lm.backbone(tparams, x, tcfg)[:, jcfg.frontend_tokens:]
        by_hand = layers.chunked_softmax_xent(
            y, tparams["embedding"], batch["labels"], tcfg.loss_chunk)
    assert float(by_hand) == got
    assert got != float(tapi.loss(tparams, {"tokens": batch["tokens"],
                                            "labels": batch["labels"]}))


def test_vlm_prefill_with_patches_past_the_window(vlm_pair):
    """ROADMAP C3 with a patch prefix: 8 patches and 16 tokens pass the
    smoke window of 16, a ragged remainder of 8.  The prefill's index counts
    the patches; logits, cache and four decode steps follow the reference's
    op-by-op run (tokens under the C1 tie rule)."""
    jcfg, japi, jparams, tcfg, tapi, tparams = vlm_pair
    s_tok, max_len = 16, 64
    toks = np.random.default_rng(24).integers(3, jcfg.vocab_size, (1, s_tok))
    jpe, tpe = _patches(jcfg, 1, jcfg.frontend_tokens, seed=25)
    s = s_tok + jcfg.frontend_tokens
    assert s > jcfg.sliding_window and (s - jcfg.sliding_window) % \
        jcfg.sliding_window != 0
    with jax.disable_jit():
        jlog, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                              "patch_embeds": jpe},
                                    max_len=max_len)
    tlog, tstate = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                          "patch_embeds": tpe},
                                max_len=max_len)
    assert tstate["index"].tolist() == [s] == np.asarray(
        jstate["index"]).tolist()
    assert tuple(tstate["kv"]["k"].shape) == jstate["kv"]["k"].shape
    assert tstate["kv"]["k"].shape[2] == jcfg.sliding_window
    for step in range(5):
        _close(tlog, jlog)
        _close(tstate["kv"]["k"], jstate["kv"]["k"])
        _close(tstate["kv"]["v"], jstate["kv"]["v"])
        jl = np.asarray(jlog, np.float32)[0]
        t = int(tlog[0].argmax())
        assert t == jl.argmax() or jl[t] >= jl.max() - (
            2 * BF16_TOL * np.abs(jl).max()), step
        if step == 4:
            break
        tok = np.asarray([[jl.argmax()]])
        with jax.disable_jit():
            jlog, jstate = japi.decode_step(jparams, jstate, jnp.asarray(tok))
        tlog, tstate = tapi.decode_step(tparams, tstate,
                                        torch.from_numpy(tok))


def test_vlm_decode_matches_parallel_forward(vlm_pair):
    """``tests/models/test_consistency.py::test_decode_matches_parallel_
    forward[llava-next-mistral-7b]``'s check on the port: the prompt token by
    token through ``decode_step`` against the parallel forward (text only,
    as the reference's test runs it), last logits within 2e-2 of
    max|logits|; and the port's parallel forward against the reference's."""
    jcfg, _, jparams, tcfg, tapi, tparams = vlm_pair
    T = 8
    toks = np.random.default_rng(42).integers(0, tcfg.vocab_size, (1, T))
    jcfg_t, tcfg_t = (dataclasses.replace(c, frontend=None)
                      for c in (jcfg, tcfg))
    tapi_t = model_api(tcfg_t, device="cpu")
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        y = lm.backbone(tparams, layers.embed(tt, tparams), tcfg_t)
        full = layers.logits_last(y[:, -1:], tparams["embedding"])
    jy = jlm.backbone(jparams, jlayers.embed(jnp.asarray(toks), jparams),
                      jcfg_t)
    _close(full, jlayers.logits_last(jy[:, -1:], jparams["embedding"]))
    state = tapi_t.make_decode_state(ShapeConfig("t", T, 1, "decode"))
    for t in range(T):
        dec, state = tapi_t.decode_step(tparams, state, tt[:, t:t + 1])
    err = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert err < 2e-2, f"decode/parallel mismatch {err}"
