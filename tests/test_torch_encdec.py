"""The encoder-decoder family of the port (``models/encdec.py``,
seamless-m4t-medium) against ``repro.models.encdec``, on the CPU at smoke
size, from the JAX package's own initial weights converted leaf by leaf.

Frames (the stubbed speech frontend's embeddings) and prompts are made with
numpy from fixed seeds.  Tolerances are those of
``tests/test_torch_models.py``: ``BF16_TOL`` of the reference's largest
magnitude on layer outputs, logits and states, with the model's steps held
against the reference run op by op (``jax.disable_jit()``, ROADMAP C7) on
its ``ideal`` backend and its tokens fed to both stacks (the port's arg-max
under the C1 tie rule; the ``reference`` backend's telemetry from a compiled
run, as in ``tests/test_torch_moe.py``);
the loss within 5e-3 relative; converted trees and state surgery exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.models import encdec as jencdec
from repro.models import model_api as j_model_api
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import (decode_state_from_numpy, encdec, model_api,
                                param_count, params_from_numpy)
from test_torch_models import BF16_TOL, _close, _np_tree
from test_torch_moe import _compiled_reference_summary

ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_config(ARCH, smoke=True)
    japi = j_model_api(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    tcfg = get_config(ARCH, smoke=True)
    tapi = model_api(tcfg, device="cpu")
    tparams = params_from_numpy(_np_tree(jparams), tapi.param_specs(), "cpu")
    return jcfg, japi, jparams, tcfg, tapi, tparams


def _frames(cfg, b, t, seed):
    fr = np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)
    return jnp.asarray(fr).astype(jnp.bfloat16), torch.from_numpy(fr)


def without_self_kv(summary, cfg, prefills, rows):
    """The JAX package's ``reference`` telemetry less what its compiled
    prefill spends projecting the prompt's self-attention K/V a second time
    (2 GEMMs a decoder layer, of ``rows`` prompt rows over ``prefills``
    prefills): the port takes them from ``attention`` (ROADMAP.md C4)."""
    L = cfg.n_layers
    return {**summary, "calls": summary["calls"] - 2 * L * prefills,
            "macs": summary["macs"] - 2 * L * rows * cfg.d_model * cfg.kv_dim}


def _layer(params, tree, key, i=0):
    return {k: v[i] for k, v in params[tree][key].items()}


def test_configs_equal_and_converted_tree_is_exact(pair):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    specs = tapi.param_specs()
    assert sorted(specs) == ["decoder", "embedding", "enc_norm", "encoder",
                             "final_norm"]
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
    assert tuple(p["encoder"]["attn"]["wq"].shape)[0] == tcfg.n_enc_layers
    assert tuple(p["decoder"]["cross_attn"]["wk"].shape)[0] == tcfg.n_layers
    for tree, key in (("encoder", "mlp"), ("decoder", "cross_attn")):
        w = next(iter(p[tree][key].values())).to(torch.float32)
        assert abs(float(w.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert p["enc_norm"].dtype == torch.float32
    assert bool((p["decoder"]["norm_cross"] == 1).all())


def test_encode_is_bidirectional_and_matches_the_reference(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    jfr, tfr = _frames(jcfg, 2, 8, seed=1)
    with jax.disable_jit():
        want = jencdec.encode(jparams, jfr, jcfg)
    with torch.inference_mode():
        got = encdec.encode(tparams, tfr, tcfg)
        assert got.dtype == torch.bfloat16
        _close(got, want)
        # the first frame sees the last one: no causal mask
        moved = tfr.clone()
        moved[:, -1] += 1.0
        assert not torch.equal(encdec.encode(tparams, moved, tcfg)[:, 0],
                               got[:, 0])


def test_cross_attention_and_project_memory(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    jmem, tmem = _frames(jcfg, 2, 4, seed=2)
    jx, tx = _frames(jcfg, 2, 5, seed=3)
    jp, tp = (_layer(p, "decoder", "cross_attn") for p in (jparams, tparams))
    jk, jv = jencdec.project_memory(jmem, jp, jcfg)
    tk, tv = encdec.project_memory(tmem.to(torch.bfloat16), tp, tcfg)
    assert tuple(tk.shape) == jk.shape == (2, 4, tcfg.n_kv_heads,
                                           tcfg.d_head)
    _close(tk, jk)
    _close(tv, jv)
    want = jencdec.cross_attention(jx, jk, jv, jp, jcfg)
    got = encdec.cross_attention(tx.to(torch.bfloat16), tk, tv, tp, tcfg)
    _close(got, want)


def test_loss_with_frames_matches_jax(pair):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    rng = np.random.default_rng(21)
    toks = rng.integers(3, jcfg.vocab_size, (2, 32))
    labels = rng.integers(3, jcfg.vocab_size, (2, 32))
    jfr, tfr = _frames(jcfg, 2, 8, seed=4)
    want = float(japi.loss(jparams, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels),
                                     "frames": jfr}))
    got = tapi.loss(tparams, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels),
                              "frames": tfr})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 5e-3 * abs(want), (float(got), want)


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_prefill_and_eight_decode_steps(pair, backend):
    """``prefill`` (index, the memory's K/V of the frames' length, the
    self-attention cache) and eight decode steps against the reference run
    op by op on its ``ideal`` backend.  Under ``reference`` the port's
    backend counts the GEMMs of the reference's compiled ``reference`` run
    but the two a decoder layer that projects the prompt's self-attention
    K/V again there."""
    jcfg, japi, jparams, tcfg, _, tparams = pair
    tapi = model_api(tcfg, backend=backend, device="cpu")
    max_len = 16
    toks = np.random.default_rng(5).integers(3, jcfg.vocab_size, (2, 6))
    jfr, tfr = _frames(jcfg, 2, max_len // jcfg.enc_frames_ratio, seed=6)
    jbatch = {"tokens": jnp.asarray(toks), "frames": jfr}
    with jax.disable_jit():
        jlog, jstate = japi.prefill(jparams, jbatch, max_len=max_len)
    tlog, tstate = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                          "frames": tfr}, max_len=max_len)
    assert tstate["index"].tolist() == [6, 6]
    assert tstate["index"].dtype == torch.int32
    mem = (tcfg.n_layers, 2, max_len // tcfg.enc_frames_ratio,
           tcfg.n_kv_heads, tcfg.d_head)
    assert tuple(tstate["mem_k"].shape) == tuple(tstate["mem_v"].shape) == mem
    assert tuple(tstate["kv"]["k"].shape) == jstate["kv"]["k"].shape
    _close(tstate["mem_k"], jstate["mem_k"])
    _close(tstate["mem_v"], jstate["mem_v"])
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
    assert np.array_equal(tstate["index"].numpy(), np.asarray(jstate["index"]))
    _close(tstate["kv"]["k"], jstate["kv"]["k"])
    _close(tstate["kv"]["v"], jstate["kv"]["v"])
    if backend == "reference":
        L, Le = tcfg.n_layers, tcfg.n_enc_layers
        got = tapi.backend.summary()
        assert got["calls"] == (7 * Le + 11 * L + 1) + 8 * (9 * L + 1)
        assert got == without_self_kv(
            _compiled_reference_summary(jcfg, jparams, jbatch, fed, max_len),
            tcfg, prefills=1, rows=toks.size)


SHAPE, SUB = (16, 3), (16, 1)


def test_decode_state_specs_and_slot_surgery(pair):
    """The counterpart of ``tests/serve/test_slots.py`` for seamless: every
    leaf (``mem_k`` / ``mem_v`` carry the batch axis) is sliced, written and
    reset one row at a time, as the reference's surgery does."""
    jcfg, japi, _, tcfg, tapi, _ = pair
    jshape, tshape = JShape("t", *SHAPE, "decode"), ShapeConfig(
        "t", *SHAPE, "decode")
    jsub_shape, tsub_shape = JShape("t", *SUB, "decode"), ShapeConfig(
        "t", *SUB, "decode")
    tspecs = tapi.decode_state_specs(tshape)
    jspecs = japi.decode_state_specs(jshape)
    assert sorted(tspecs) == sorted(jspecs) == ["index", "kv", "mem_k",
                                                "mem_v"]
    for key in ("mem_k", "mem_v", "index"):
        assert tspecs[key].shape == jspecs[key].shape
        assert tspecs[key].logical == jspecs[key].logical
    assert tspecs["mem_k"].shape[2] == SHAPE[0] // tcfg.enc_frames_ratio
    rng = np.random.default_rng(9)
    jstate = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 4).astype(
            x.dtype), japi.make_decode_state(jshape))
    tstate = decode_state_from_numpy(_np_tree(jstate), tspecs, "cpu")

    def same(tt, jt):
        for k in jt:
            if isinstance(jt[k], dict):
                same(tt[k], jt[k])
            else:
                assert np.array_equal(tt[k].to(torch.float32).numpy(),
                                      np.asarray(jt[k].astype(jnp.float32))), k

    jsub = japi.slot_slice(jshape, jstate, 1)
    tsub = tapi.slot_slice(tshape, tstate, 1)
    same(tsub, jsub)
    assert tuple(tsub["mem_k"].shape)[1] == 1
    ones = jax.tree.map(lambda z: jnp.full_like(z, 1),
                        japi.make_decode_state(jsub_shape))
    tones = decode_state_from_numpy(
        _np_tree(ones), tapi.decode_state_specs(tsub_shape), "cpu")
    jstate = japi.slot_update(jshape, jstate, 2, ones)
    assert tapi.slot_update(tshape, tstate, 2, tones) is tstate
    same(tstate, jstate)                    # rows 0, 1 untouched, row 2 ones
    assert bool((tstate["mem_v"][:, 2] == 1).all())
    same(tsub, jsub)                        # the slice was a copy
    same(tapi.slot_reset(tshape, tstate, 0), japi.slot_reset(jshape, jstate,
                                                             0))
    assert not bool(tstate["mem_k"][:, 0].any())
