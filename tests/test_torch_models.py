"""The port's ``models`` package against ``repro.models``, on the CPU, with
the JAX package's own initial weights converted leaf by leaf.

Both stacks keep activations in bf16 and accumulate in f32, but they round
to bf16 at other places (XLA fuses differently from eager PyTorch) and their
transcendental functions differ in the last bit, so outputs are compared in
f32 against ``BF16_TOL = 4 * 2^-8`` of the reference's largest magnitude:
four bf16 roundings' worth, where one rounding is 2^-8 relative.  Arg-max
tokens must be equal at every step.
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
from repro.models import model_api as j_model_api
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import (decode_state_from_numpy, layers, model_api,
                                param_count, params_from_numpy)

BF16_TOL = 4 * 2.0 ** -8
ARCH_NAMES = ("phi4-mini-3.8b", "starcoder2-3b")      # swiglu, gelu + bias


def _np_tree(tree):
    """A JAX tree as nested dicts of numpy arrays, bf16 leaves as f32."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if tree.dtype == jnp.bfloat16:
        return np.asarray(tree.astype(jnp.float32))
    return np.asarray(tree)


def _close(got, want, tol=BF16_TOL):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-6))


@pytest.fixture(scope="module", params=ARCH_NAMES)
def pair(request):
    """(jax cfg, jax api, jax params, torch cfg, torch api, torch params)."""
    jcfg = j_get_config(request.param, smoke=True)
    japi = j_model_api(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    tcfg = get_config(request.param, smoke=True)
    tapi = model_api(tcfg, device="cpu")
    tparams = params_from_numpy(_np_tree(jparams), tapi.param_specs(), "cpu")
    return jcfg, japi, jparams, tcfg, tapi, tparams


def _layer0(params, key):
    return {k: v[0] for k, v in params["blocks"][key].items()}


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


def test_configs_equal_and_converted_tree_is_exact(pair):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert sorted(ARCHS) == sorted(__import__("repro.configs").configs.ARCHS)
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


def test_init_params_scales_and_dtypes(pair):
    *_, tcfg, tapi, _ = pair
    p = tapi.init_params(seed=3)
    q = tapi.init_params(seed=3)
    emb = p["embedding"].to(torch.float32)
    assert torch.equal(emb, q["embedding"].to(torch.float32))
    assert p["embedding"].dtype == torch.bfloat16
    assert abs(float(emb.std()) - 0.02) < 0.002
    wq = p["blocks"]["attn"]["wq"].to(torch.float32)
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert p["final_norm"].dtype == torch.float32
    assert bool((p["blocks"]["norm_attn"] == 1).all())


def test_rmsnorm_and_rope(pair):
    jcfg, *_ , tcfg, _, _ = pair
    jx, tx = _x(jcfg, 2, 5, seed=1)
    scale = np.random.default_rng(2).uniform(0.5, 1.5, jcfg.d_model) \
        .astype(np.float32)
    _close(layers.rmsnorm(tx, torch.from_numpy(scale)),
           jlayers.rmsnorm(jx, jnp.asarray(scale)))
    jq = jx.reshape(2, 5, -1, jcfg.d_head)
    tq = tx.reshape(2, 5, -1, tcfg.d_head)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 30]])
    _close(layers.apply_rope(tq, torch.from_numpy(pos), tcfg.rope_theta),
           jlayers.apply_rope(jq, jnp.asarray(pos), jcfg.rope_theta))
    np.testing.assert_allclose(
        layers.rope_frequencies(tcfg.d_head, tcfg.rope_theta).numpy(),
        np.asarray(jlayers.rope_frequencies(jcfg.d_head, jcfg.rope_theta)),
        rtol=1e-6)


@pytest.mark.parametrize("variant", ["plain", "chunked", "window", "grouped",
                                     "bf16_scores"])
def test_attention(pair, variant):
    jcfg, _, jparams, tcfg, _, tparams = pair
    over = {"plain": {}, "chunked": {"attn_chunk": 4},
            "window": {"sliding_window": 3, "attn_chunk": 4},
            "grouped": {"gqa_grouped": True},
            "bf16_scores": {"attn_scores_f32": False}}[variant]
    jcfg, tcfg = (dataclasses.replace(c, **over) for c in (jcfg, tcfg))
    jx, tx = _x(jcfg, 2, 8, seed=3)
    jo, jk, jv = jlayers.attention(jx, _layer0(jparams, "attn"), jcfg,
                                   return_kv=True)
    to, tk, tv = layers.attention(tx, _layer0(tparams, "attn"), tcfg,
                                  return_kv=True)
    # the bf16 score pipeline rounds the scores themselves: twice the slack
    tol = BF16_TOL * (2 if variant == "bf16_scores" else 1)
    _close(to, jo, tol)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("variant", ["per_row", "ring", "int8", "past_end"])
def test_decode_attention(pair, variant):
    jcfg, _, jparams, tcfg, _, tparams = pair
    b, S = 3, 8
    index = np.array([2, 5, 0], np.int32)
    if variant == "ring":                 # cache no longer than the window
        jcfg, tcfg = (dataclasses.replace(c, sliding_window=S)
                      for c in (jcfg, tcfg))
        index = np.array([3, 9, 21], np.int32)       # rows 1, 2 have wrapped
    elif variant == "past_end":           # an idle slot keeps counting
        index = np.array([2, S + 3, 7], np.int32)
    rng = np.random.default_rng(4)
    shape = (b, S, jcfg.n_kv_heads, jcfg.d_head)
    if variant == "int8":
        jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype="int8")
                      for c in (jcfg, tcfg))
        kv = {"k": rng.integers(-127, 128, shape).astype(np.int8),
              "v": rng.integers(-127, 128, shape).astype(np.int8),
              "k_scale": rng.uniform(0.001, 0.02, shape[:-1] + (1,))
              .astype(np.float32),
              "v_scale": rng.uniform(0.001, 0.02, shape[:-1] + (1,))
              .astype(np.float32)}
        jkv = {k: jnp.asarray(v) for k, v in kv.items()}
        tkv = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    else:
        kv = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
        jkv = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in kv.items()}
        tkv = {k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in kv.items()}
    jx, tx = _x(jcfg, b, 1, seed=5)
    jo, jnew = jlayers.decode_attention(jx, _layer0(jparams, "attn"), jcfg,
                                        jkv, jnp.asarray(index))
    to, tnew = layers.decode_attention(tx, _layer0(tparams, "attn"), tcfg,
                                       tkv, torch.from_numpy(index))
    _close(to, jo)
    assert tnew["k"] is tkv["k"]              # written in place
    for key in jnew:
        if jnew[key].dtype == jnp.int8:
            # one quantisation step where the bf16 K/V differ in a last bit
            diff = np.abs(tnew[key].numpy().astype(np.int32)
                          - np.asarray(jnew[key]).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        else:
            _close(tnew[key], jnew[key])


def test_mlp(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    jx, tx = _x(jcfg, 2, 5, seed=6)
    _close(layers.mlp(tx, _layer0(tparams, "mlp"), tcfg),
           jlayers.mlp(jx, _layer0(jparams, "mlp"), jcfg))


#: prompt seeds for which, at every one of the nine steps, the two largest
#: logits lie further apart (>= 2 % of max|logits|, the widest among 120
#: seeds tried) than the two stacks' rounding noise, which reaches about 1 %
#: at the worst of the vocabulary's entries (see the module docstring).  With random weights the bf16
#: logits often tie exactly, and a tie is decided by that noise in either
#: stack, so other seeds can flip a token without either stack being wrong.
PROMPT_SEED = {"phi4-mini-3.8b": 213, "starcoder2-3b": 129}


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_prefill_and_eight_decode_steps(pair, backend):
    jcfg, _, jparams, tcfg, _, tparams = pair
    japi = j_model_api(jcfg, backend=backend)
    tapi = model_api(tcfg, backend=backend, device="cpu")
    toks = np.random.default_rng(PROMPT_SEED[jcfg.name]
                                 ).integers(3, jcfg.vocab_size, (2, 6))
    jlog, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                max_len=16)
    tlog, tstate = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                max_len=16)
    assert tlog.dtype == torch.float32
    assert tuple(tlog.shape) == (2, tcfg.padded_vocab)
    _close(tlog, jlog)
    jstep = jax.jit(japi.decode_step)
    for step in range(8):
        jtok = np.asarray(jlog).argmax(-1)
        ttok = tlog.argmax(-1).numpy()
        assert np.array_equal(jtok, ttok), f"step {step}"
        jlog, jstate = jstep(jparams, jstate, jnp.asarray(jtok[:, None]))
        tlog, tstate = tapi.decode_step(tparams, tstate,
                                        torch.from_numpy(ttok[:, None]))
        _close(tlog, jlog)
    assert np.array_equal(np.asarray(jlog).argmax(-1),
                          tlog.argmax(-1).numpy())
    assert np.array_equal(tstate["index"].numpy(), np.asarray(jstate["index"]))
    _close(tstate["kv"]["k"], jstate["kv"]["k"])
    _close(tstate["kv"]["v"], jstate["kv"]["v"])
    if backend == "reference":
        calls = (7 if tcfg.act == "swiglu" else 6) * tcfg.n_layers + 1
        assert tapi.backend.summary()["calls"] == 9 * calls
        assert tapi.backend.summary() == japi.backend.summary()


def test_decode_state_round_trip_and_slot_surgery(pair):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jshape, tshape = JShape("s", 8, 3, "decode"), ShapeConfig("s", 8, 3,
                                                              "decode")
    rng = np.random.default_rng(9)
    jstate = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 4).astype(x.dtype),
        japi.make_decode_state(jshape))
    specs = tapi.decode_state_specs(tshape)
    tstate = decode_state_from_numpy(_np_tree(jstate), specs, "cpu")
    zero = tapi.make_decode_state(tshape)
    assert tuple(zero["kv"]["k"].shape) == jstate["kv"]["k"].shape
    assert not bool(zero["kv"]["k"].any()) and zero["index"].dtype == torch.int32

    def same(tt, jt):
        for k in jt:
            if isinstance(jt[k], dict):
                same(tt[k], jt[k])
            else:
                assert np.array_equal(tt[k].to(torch.float32).numpy(),
                                      np.asarray(jt[k].astype(jnp.float32))), k

    same(tstate, jstate)
    jsub = japi.slot_slice(jshape, jstate, 1)
    tsub = tapi.slot_slice(tshape, tstate, 1)
    same(tsub, jsub)
    fresh = jax.tree.map(lambda x: x + 1, jsub)
    tfresh = decode_state_from_numpy(
        _np_tree(fresh), tapi.decode_state_specs(ShapeConfig("s", 8, 1,
                                                             "decode")), "cpu")
    jstate2 = japi.slot_update(jshape, jstate, 2, fresh)
    tstate2 = tapi.slot_update(tshape, tstate, 2, tfresh)
    assert tstate2 is tstate                  # in place, same tree
    same(tstate2, jstate2)                    # rows 0, 1 untouched, row 2 new
    same(tsub, jsub)                          # the slice was a copy
    jstate3 = japi.slot_reset(jshape, jstate2, 0)
    same(tapi.slot_reset(tshape, tstate, 0), jstate3)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_builds(arch):
    """Every shipped config's family is ported: its smoke model builds and
    its spec tree is the reference's, leaf for leaf."""
    cfg = get_config(arch, smoke=True)
    api = model_api(cfg, device="cpu")
    want = j_model_api(j_get_config(arch, smoke=True)).param_specs()
    assert param_count(api.param_specs()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(
            want, is_leaf=lambda x: hasattr(x, "logical")))


@pytest.mark.parametrize("arch", ["granite-20b", "qwen1.5-110b"])
def test_other_dense_configs_run(arch):
    cfg = get_config(arch, smoke=True)
    api = model_api(cfg, device="cpu")
    params = api.init_params(0)
    logits, state = api.prefill(params, {"tokens": torch.tensor([[3, 4, 5]])},
                                max_len=8)
    logits, state = api.decode_step(params, state, logits.argmax(-1)[:, None])
    assert tuple(logits.shape) == (1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert state["index"].tolist() == [4]


def test_loss_matches_jax(pair):
    """``ModelAPI.loss`` (``lm.backbone`` + the chunked cross-entropy, a
    forward pass) against the reference's loss, within 5e-3 relative; 40
    positions against the smoke ``loss_chunk`` of 32 take the whole-sequence
    chunk."""
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    rng = np.random.default_rng(21)
    for s in (32, 40):
        toks = rng.integers(3, jcfg.vocab_size, (2, s))
        labels = rng.integers(3, jcfg.vocab_size, (2, s))
        want = float(japi.loss(jparams, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)}))
        got = tapi.loss(tparams, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 5e-3 * abs(want), (s, float(got),
                                                             want)


def test_sliding_window_prefill_longer_than_the_cache(pair):
    """ROADMAP C3: a sliding-window prompt longer than the cache, with a
    ragged remainder.  ``prefill`` stores the last ``cache_len`` positions
    at slots 0..cache_len-1 and ``decode_step`` then writes position p at
    slot p % cache_len; the two agree only when (s - cache_len) is a
    multiple of cache_len.  Both packages do the same, so the port must
    equal the reference step for step: logits within BF16_TOL, the cache,
    and tokens under the C1 tie rule (the reference's token is fed to
    both, and the port's arg-max must be it or lie within 2 x BF16_TOL of
    max|logits| of its logit)."""
    jcfg, _, jparams, tcfg, _, tparams = pair
    jcfg, tcfg = (dataclasses.replace(c, sliding_window=4)
                  for c in (jcfg, tcfg))
    japi, tapi = j_model_api(jcfg), model_api(tcfg, device="cpu")
    s, max_len = 7, 16
    toks = np.random.default_rng(PROMPT_SEED[jcfg.name]
                                 ).integers(3, jcfg.vocab_size, (2, s))
    jlog, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                max_len=max_len)
    tlog, tstate = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                max_len=max_len)
    cache_len = tstate["kv"]["k"].shape[2]
    assert cache_len == 4 < s and (s - cache_len) % cache_len != 0
    assert jstate["kv"]["k"].shape == tuple(tstate["kv"]["k"].shape)
    _close(tstate["kv"]["k"], jstate["kv"]["k"])
    _close(tstate["kv"]["v"], jstate["kv"]["v"])
    jstep = jax.jit(japi.decode_step)
    for step in range(4):
        _close(tlog, jlog)
        jl, tl = np.asarray(jlog, np.float32), tlog.numpy()
        jtok = jl.argmax(-1)
        for row, t in enumerate(tl.argmax(-1)):
            assert t == jtok[row] or jl[row, t] >= jl[row].max() - (
                2 * BF16_TOL * np.abs(jl[row]).max()), (step, row)
        jlog, jstate = jstep(jparams, jstate, jnp.asarray(jtok[:, None]))
        tlog, tstate = tapi.decode_step(tparams, tstate,
                                        torch.from_numpy(jtok[:, None]))
    _close(tlog, jlog)
    assert np.array_equal(tstate["index"].numpy(), np.asarray(jstate["index"]))
    _close(tstate["kv"]["k"], jstate["kv"]["k"])
    _close(tstate["kv"]["v"], jstate["kv"]["v"])
