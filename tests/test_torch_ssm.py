"""The state-space slice of the port against the JAX package, on the CPU:
the ``wkv6`` and ``ssd_chunk`` kernels' plain versions, ``models/ssm.py``
(Mamba2, RWKV6, Zamba2) and ``ModelAPI.loss`` / ``decode_step`` for
rwkv6-1.6b and zamba2-2.7b at smoke size.

Inputs are made with numpy from fixed seeds and handed to both stacks;
weights are the JAX package's own initial weights converted leaf by leaf.

Tolerances:

* kernels: those of ``tests/kernels/test_kernels.py`` — the plain versions
  against ``repro.kernels.ref`` (naive scans) and the Pallas kernels in
  interpret mode at rtol = atol = 2e-4 (wkv6) and 3e-4 (ssd), and the model's
  chunked form at rtol 1e-4, atol 1e-5;
* model pieces and decode logits: ``BF16_TOL = 4 * 2^-8`` of the reference's
  largest magnitude (``tests/test_torch_models.py``).  The decode steps are
  held against the reference run op by op (``jax.disable_jit()``): compiled,
  XLA fuses the step's elementwise bf16 work and rounds at other places, and
  on zamba2 smoke the compiled and the op-by-op reference differ by up to
  2.6 % of max|logits| over eight steps (rwkv6: 1.3 %), more than the
  tolerance, while the port follows the op-by-op reference within it;
* ``loss``: within 5e-3 relative of the reference's (compiled) loss.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunk as j_ssd_chunk
from repro.kernels.wkv6 import wkv6 as j_wkv6
from repro.models import model_api as j_model_api
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import ssd_op, wkv6_op
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_plain
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
from repro_torch.models import (decode_state_from_numpy, layers, model_api,
                                param_count, params_from_numpy)
from repro_torch.models import ssm as tssm
from test_torch_models import BF16_TOL, _close, _np_tree

ARCH_NAMES = ("rwkv6-1.6b", "zamba2-2.7b")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(*arrays):
    """numpy arrays -> (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


# ---------------------------------------------------------------- kernels ----


def _wkv_inputs(b, s, h, p, seed, decay=0.5, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    w_log = -np.exp(rng.standard_normal((b, s, h, p)) * decay).astype(
        np.float32)
    u = (rng.standard_normal((h, p)) * 0.1).astype(np.float32)
    s0 = ((rng.standard_normal((b, h, p, p)) * 0.1).astype(np.float32)
          if state else np.zeros((b, h, p, p), np.float32))
    return r, k, v, w_log, u, s0


def _ssd_inputs(b, s, h, p, n, seed, state=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, p)).astype(np.float32) if state
          else np.zeros((b, h, n, p), np.float32))
    return x, dt, A_log, B, C, D, s0


def _assert_pair(got, want, rtol, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("b,s,h,p,chunk", [(2, 64, 2, 16, 16),
                                           (1, 128, 3, 32, 32),
                                           (2, 32, 1, 8, 32)])
def test_wkv6_plain_matches_jax_ref_and_pallas(b, s, h, p, chunk):
    args = _wkv_inputs(b, s, h, p, seed=b * s)
    jargs, targs = _both(*args)
    got = wkv6_plain(*targs, chunk=chunk)
    _assert_pair(got, jref.wkv6(*jargs), 2e-4, 2e-4)
    _assert_pair(got, j_wkv6(*jargs, chunk=chunk, interpret=True), 2e-4, 2e-4)
    # the wrapper takes the plain version for CPU tensors (PyTorch's CPU
    # products may split their sums by the threads at hand: not bit for
    # bit), and the oracle of the port equals the JAX package's
    _assert_pair(wkv6(*targs, chunk=chunk), got, 1e-6, 1e-6)
    _assert_pair(wkv6_op(*targs, chunk=chunk), got, 1e-6, 1e-6)
    _assert_pair(tref.wkv6(*targs), jref.wkv6(*jargs), 1e-5, 1e-5)


def test_wkv6_plain_matches_the_models_chunked_form():
    """The plain version (the kernel's function) == the reference model's
    wkv6_chunked at the tolerance of test_wkv6_matches_model_chunked_form."""
    args = _wkv_inputs(1, 64, 2, 16, seed=7, decay=0.3, state=False)
    jargs, targs = _both(*args)
    _assert_pair(wkv6_plain(*targs, chunk=16),
                 jssm.wkv6_chunked(*jargs, 16), 1e-4, 1e-5)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 2, 16, 8, 16),
                                             (1, 96, 4, 32, 16, 32),
                                             (2, 32, 1, 8, 4, 8)])
def test_ssd_plain_matches_jax_ref_and_pallas(b, s, h, p, n, chunk):
    args = _ssd_inputs(b, s, h, p, n, seed=s + h)
    jargs, targs = _both(*args)
    got = ssd_chunk_plain(*targs, chunk=chunk)
    _assert_pair(got, jref.ssd(*jargs), 3e-4, 3e-4)
    _assert_pair(got, j_ssd_chunk(*jargs, chunk=chunk, interpret=True), 3e-4,
                 3e-4)
    _assert_pair(ssd_chunk(*targs, chunk=chunk), got, 1e-6, 1e-6)
    _assert_pair(ssd_op(*targs, chunk=chunk), got, 1e-6, 1e-6)
    _assert_pair(tref.ssd(*targs), jref.ssd(*jargs), 1e-5, 1e-5)


def test_ssd_plain_nonzero_initial_state():
    args = _ssd_inputs(1, 32, 2, 8, 4, seed=11, state=True)
    jargs, targs = _both(*args)
    got = ssd_chunk_plain(*targs, chunk=8)
    _assert_pair(got, jref.ssd(*jargs), 3e-4, 3e-4)
    _assert_pair(got, j_ssd_chunk(*jargs, chunk=8, interpret=True), 3e-4,
                 3e-4)


@pytest.mark.parametrize("kernel", ["wkv6", "ssd_chunk"])
def test_state_out_may_be_the_state(kernel):
    """The final state written into the state tensor itself equals the
    result with a fresh output."""
    if kernel == "wkv6":
        args = [torch.from_numpy(a) for a in _wkv_inputs(2, 16, 2, 8, 3)]
        fn = wkv6
    else:
        args = [torch.from_numpy(a) for a in _ssd_inputs(2, 16, 2, 8, 4, 3,
                                                         state=True)]
        fn = ssd_chunk
    y, S = fn(*args, chunk=8)
    state = args[-1].clone()
    y2, S2 = fn(*args[:-1], state, chunk=8, state_out=state)
    assert S2 is state
    _assert_pair((y2, S2), (y, S), 1e-6, 1e-6)


@pytest.mark.parametrize("bad", ["chunk", "shape", "state_out", "device"])
def test_kernel_wrappers_reject(bad):
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _wkv_inputs(1, 12, 2, 8, 4))
    x, dt, A, B, C, D, z0 = (torch.from_numpy(a)
                             for a in _ssd_inputs(1, 12, 2, 8, 4, 4))
    if bad == "chunk":               # a chunk must divide the sequence
        with pytest.raises(ValueError, match="does not divide"):
            wkv6(r, k, v, w, u, s0, chunk=8)
        with pytest.raises(ValueError, match="does not divide"):
            ssd_chunk(x, dt, A, B, C, D, z0, chunk=8)
        assert wkv6(r, k, v, w, u, s0)[0].shape == r.shape    # chunk=None
    elif bad == "shape":
        with pytest.raises(ValueError):
            wkv6(r, k, v, w[:, :6], u, s0)
        with pytest.raises(ValueError):
            ssd_chunk(x, dt, A, B[..., :3], C, D, z0)
    elif bad == "state_out":
        with pytest.raises(ValueError, match="state_out"):
            wkv6(r, k, v, w, u, s0, state_out=s0.to(torch.float64))
        with pytest.raises(ValueError, match="state_out"):
            ssd_chunk(x, dt, A, B, C, D, z0, state_out=z0[:, :1])
    else:
        with pytest.raises(ValueError, match="no kernel for device"):
            wkv6(*(t.to("meta") for t in (r, k, v, w, u, s0)))
        with pytest.raises(ValueError, match="no kernel for device"):
            ssd_chunk(*(t.to("meta") for t in (x, dt, A, B, C, D, z0)))


# ------------------------------------------------- the model's chunked WKV ----


#: the tolerance (rtol 1e-4, atol 1e-5) is the JAX test's at chunk 16.  The
#: centred exponents reach +-lw_end / 2, so the f32 rounding of a chunk's
#: terms grows with its length: at a 50-row chunk the two stacks' orders of
#: summation already differ by up to that tolerance.  The ragged case keeps
#: its chunk (20) near 16; long chunks are held against the plain version on
#: the card by chip_smoke.py, relative to max|y|.
@pytest.mark.parametrize("b,s,h,p,chunk", [
    (1, 64, 2, 16, 16),          # the JAX test's shape
    (2, 20, 2, 16, 16),          # ragged: 16 does not divide 20 -> ch = 20
    (2, 8, 3, 8, 1),             # ch = 1
    (3, 1, 2, 16, 64),           # one decode step, non-zero state
])
def test_wkv6_chunked_matches_jax_model(b, s, h, p, chunk):
    args = _wkv_inputs(b, s, h, p, seed=s + chunk, decay=0.3,
                       state=s == 1)
    jargs, targs = _both(*args)
    got = tssm.wkv6_chunked(*targs, chunk)
    _assert_pair(got, jssm.wkv6_chunked(*jargs, chunk), 1e-4, 1e-5)


def test_model_chunked_forms_are_one_kernel_call(monkeypatch):
    """``wkv6_chunked`` and the SSD core of ``mamba2_forward`` each call
    their kernel's wrapper once, at the model's chunk rule."""
    calls = []

    def spy(real, name):
        def fn(*args, chunk, **kw):
            calls.append((name, args[0].shape[1], chunk))
            return real(*args, chunk=chunk, **kw)
        return fn

    monkeypatch.setattr(tssm, "wkv6", spy(wkv6, "wkv6"))
    monkeypatch.setattr(tssm, "ssd_chunk", spy(ssd_chunk, "ssd_chunk"))
    r = torch.zeros(1, 20, 2, 8)
    tssm.wkv6_chunked(r, r, r, r, torch.zeros(2, 8), torch.zeros(1, 2, 8, 8),
                      8)
    tssm.wkv6_chunked(r, r, r, r, torch.zeros(2, 8), torch.zeros(1, 2, 8, 8),
                      4)
    *_, tcfg, tapi, tparams = _pair("zamba2-2.7b")
    lp = {k: v[0] for k, v in tparams["mamba"].items()}
    x = torch.zeros(2, 12, tcfg.d_model, dtype=torch.bfloat16)
    tssm.mamba2_forward(x, lp, tcfg)
    tssm.mamba2_forward(x[:, :8], lp, tcfg)
    assert calls == [("wkv6", 20, 20), ("wkv6", 20, 4), ("ssd_chunk", 12, 12),
                     ("ssd_chunk", 8, tcfg.ssm_chunk)]


# ------------------------------------------------------------ model pieces ----


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax cfg, jax api, jax params, torch cfg, torch api, torch params)."""
    jcfg = j_get_config(arch, smoke=True)
    japi = j_model_api(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    tcfg = get_config(arch, smoke=True)
    tapi = model_api(tcfg, device="cpu")
    tparams = params_from_numpy(_np_tree(jparams), tapi.param_specs(), "cpu")
    return jcfg, japi, jparams, tcfg, tapi, tparams


@pytest.fixture(params=ARCH_NAMES)
def pair(request):
    return _pair(request.param)


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _layer(params, key, i=0):
    return {k: v[i] for k, v in params[key].items()}


def _perturbed(params, key, names, seed):
    """Layer 0 of ``params[key]`` with the zero-initialised vectors drawn
    at random (so the mixes, decays and bonus all matter), as numpy."""
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(_f32(v)) for k, v in _layer(params, key).items()}
    for name in names:
        out[name] = (rng.standard_normal(out[name].shape) * 0.5).astype(
            np.float32)
    return out


def _lp_pair(jparams, specs, key, names, seed):
    lp = _perturbed(jparams, key, names, seed)
    jlp = {k: jnp.asarray(v).astype(jparams[key][k].dtype)
           for k, v in lp.items()}
    tlp = {k: torch.from_numpy(np.array(v)).to(specs[key][k].dtype)
           for k, v in lp.items()}
    return jlp, tlp


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
        assert np.array_equal(_f32(tt), _f32(jt))
    check(jparams, tparams, specs)


@pytest.mark.parametrize("return_state", [False, True])
def test_mamba2_forward(return_state):
    jcfg, _, jparams, tcfg, tapi, tparams = _pair("zamba2-2.7b")
    jlp, tlp = _lp_pair(jparams, tapi.param_specs(), "mamba",
                        ("A_log", "dt_bias"), seed=1)
    dims = tssm.mamba2_dims(tcfg)
    jx, tx = _x(jcfg, 2, 12, seed=2)          # 12: a ragged chunk (ch = 12)
    rng = np.random.default_rng(3)
    ss = rng.standard_normal((2, dims["n_heads"], dims["d_state"],
                              dims["p"])).astype(np.float32)
    cs = rng.standard_normal((2, 3, dims["conv_dim"])).astype(np.float32)
    kw_j = kw_t = {}
    if return_state:
        kw_j = dict(ssm_state=jnp.asarray(ss),
                    conv_state=jnp.asarray(cs).astype(jnp.bfloat16),
                    return_state=True)
        kw_t = dict(ssm_state=torch.from_numpy(ss),
                    conv_state=torch.from_numpy(cs).to(torch.bfloat16),
                    return_state=True)
    jo = jssm.mamba2_forward(jx, jlp, jcfg, **kw_j)
    to = tssm.mamba2_forward(tx, tlp, tcfg, **kw_t)
    if not return_state:
        _close(to, jo)
        return
    for got, want in zip(to, jo):
        _close(got, want)
    assert to[2].dtype == torch.bfloat16


def test_mamba2_step():
    jcfg, _, jparams, tcfg, tapi, tparams = _pair("zamba2-2.7b")
    jlp, tlp = _lp_pair(jparams, tapi.param_specs(), "mamba",
                        ("A_log", "dt_bias"), seed=4)
    dims = tssm.mamba2_dims(tcfg)
    jx, tx = _x(jcfg, 3, 1, seed=5)
    rng = np.random.default_rng(6)
    ss = rng.standard_normal((3, dims["n_heads"], dims["d_state"],
                              dims["p"])).astype(np.float32)
    cs = rng.standard_normal((3, 3, dims["conv_dim"])).astype(np.float32)
    jout = jssm.mamba2_step(jx, jlp, jcfg, jnp.asarray(ss),
                            jnp.asarray(cs).astype(jnp.bfloat16))
    tout = tssm.mamba2_step(tx, tlp, tcfg, torch.from_numpy(ss),
                            torch.from_numpy(cs).to(torch.bfloat16))
    for got, want in zip(tout, jout):
        _close(got, want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("decode", [False, True])
def test_rwkv6_timemix(fused, decode):
    jcfg, _, jparams, tcfg, tapi, tparams = _pair("rwkv6-1.6b")
    jcfg, tcfg = (dataclasses.replace(c, fused_rwkv_proj=fused)
                  for c in (jcfg, tcfg))
    jlp, tlp = _lp_pair(jparams, tapi.param_specs(), "blocks",
                        ("tmix_mu", "w_base", "u"), seed=7)
    dims = tssm.rwkv6_dims(tcfg)
    b, s = (3, 1) if decode else (2, 20)      # 20: ragged against chunk 8
    jx, tx = _x(jcfg, b, s, seed=8)
    if not decode:
        _close(tssm.rwkv6_timemix(tx, tlp, tcfg),
               jssm.rwkv6_timemix(jx, jlp, jcfg))
        return
    rng = np.random.default_rng(9)
    st = (rng.standard_normal((b, dims["h"], dims["p"], dims["p"])) * 0.1
          ).astype(np.float32)
    prev = rng.standard_normal((b, tcfg.d_model)).astype(np.float32)
    jout = jssm.rwkv6_timemix(jx, jlp, jcfg, state=jnp.asarray(st),
                              prev=jnp.asarray(prev).astype(jnp.bfloat16),
                              return_state=True)
    tst = torch.from_numpy(st.copy())
    tout = tssm.rwkv6_timemix(tx, tlp, tcfg, state=tst,
                              prev=torch.from_numpy(prev).to(torch.bfloat16),
                              return_state=True, state_out=tst)
    assert tout[1] is tst                         # written in place
    for got, want in zip(tout, jout):
        _close(got, want)


@pytest.mark.parametrize("decode", [False, True])
def test_rwkv6_channelmix(decode):
    jcfg, _, jparams, tcfg, tapi, tparams = _pair("rwkv6-1.6b")
    jlp, tlp = _lp_pair(jparams, tapi.param_specs(), "blocks", ("cmix_mu",),
                        seed=10)
    jx, tx = _x(jcfg, 2, 1 if decode else 7, seed=11)
    if not decode:
        _close(tssm.rwkv6_channelmix(tx, tlp), jssm.rwkv6_channelmix(jx, jlp))
        return
    prev = np.random.default_rng(12).standard_normal(
        (2, tcfg.d_model)).astype(np.float32)
    jout = jssm.rwkv6_channelmix(jx, jlp, jnp.asarray(prev).astype(
        jnp.bfloat16), return_state=True)
    tout = tssm.rwkv6_channelmix(tx, tlp, torch.from_numpy(prev).to(
        torch.bfloat16), return_state=True)
    for got, want in zip(tout, jout):
        _close(got, want)


def test_chunked_softmax_xent(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    from repro.models import layers as jlayers
    jx, tx = _x(jcfg, 2, 40, seed=13)         # 40 against loss_chunk 32: ragged
    labels = np.random.default_rng(14).integers(0, jcfg.vocab_size, (2, 40))
    for chunk in (8, jcfg.loss_chunk):
        want = float(jlayers.chunked_softmax_xent(
            jx, jparams["embedding"], jnp.asarray(labels), chunk))
        got = layers.chunked_softmax_xent(tx, tparams["embedding"],
                                          torch.from_numpy(labels), chunk)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-5 * abs(want)


# ------------------------------------------------------------- the models ----


def test_loss_matches_jax(pair, capsys):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    rng = np.random.default_rng(15)
    toks = rng.integers(3, jcfg.vocab_size, (2, 24))
    labels = rng.integers(3, jcfg.vocab_size, (2, 24))
    want = float(japi.loss(jparams, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)}))
    got = tapi.loss(tparams, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and got.dim() == 0
    gap = abs(float(got) - want) / abs(want)
    with capsys.disabled():
        print(f"\n{jcfg.name} smoke loss: port {float(got):.6f}, JAX "
              f"{want:.6f}, relative gap {gap:.2e}")
    assert gap <= 5e-3


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_eight_decode_steps(pair, backend):
    """Eight decode steps against the reference run op by op on its
    ``ideal`` backend (whose GEMMs the port's ``reference`` one computes at
    nominal rails).  The reference's ``reference`` backend runs compiled
    only: its host callback dispatches JAX operations, which can deadlock
    against a computation run op by op.  Compiled, it is held against a
    compiled ``ideal`` run on the same tokens (logits and state within
    BF16_TOL: the reference backend computes the numbers the op-by-op
    ``ideal`` run witnesses), and the port's telemetry against its."""
    jcfg, japi, jparams, tcfg, _, tparams = pair
    tapi = model_api(tcfg, backend=backend, device="cpu")
    jshape, tshape = JShape("s", 16, 2, "decode"), ShapeConfig("s", 16, 2,
                                                              "decode")
    jstate, tstate = japi.make_decode_state(jshape), tapi.make_decode_state(
        tshape)
    toks = np.random.default_rng(0).integers(3, jcfg.vocab_size, (2, 1))
    fed = []
    for step in range(8):
        fed.append(toks)
        with jax.disable_jit():
            jlog, jstate = japi.decode_step(jparams, jstate, jnp.asarray(toks))
        tlog, tstate2 = tapi.decode_step(tparams, tstate,
                                         torch.from_numpy(toks))
        assert tstate2 is tstate                     # updated in place
        assert tlog.dtype == torch.float32
        assert tuple(tlog.shape) == (2, tcfg.padded_vocab)
        _close(tlog, jlog)
        # the same token wherever the top two stand apart (ROADMAP.md C1)
        jl = np.asarray(jlog)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        apart = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL * np.abs(jl).max()
        jtok, ttok = jl.argmax(-1), tlog.argmax(-1).numpy()
        assert np.array_equal(jtok[apart], ttok[apart]), f"step {step}"
        toks = jtok[:, None]
    assert tstate["index"].tolist() == np.asarray(jstate["index"]).tolist()
    for key in jstate:
        if key == "kv":
            for kk in ("k", "v"):
                _close(tstate["kv"][kk], jstate["kv"][kk])
        elif key != "index":
            _close(tstate[key], jstate[key])
    if backend == "reference":
        compiled = {}
        for name in ("ideal", "reference"):
            api = j_model_api(jcfg, backend=name)
            state, step, logits = api.make_decode_state(jshape), jax.jit(
                api.decode_step), []
            for toks in fed:
                jlog, state = step(jparams, state, jnp.asarray(toks))
                logits.append(jlog)
            compiled[name] = api, logits, state
        jref, ref_logits, ref_state = compiled["reference"]
        _, ideal_logits, ideal_state = compiled["ideal"]
        for got, want in zip(ref_logits, ideal_logits):
            _close(got, want)
        for key in ref_state:
            if key == "kv":
                for kk in ("k", "v"):
                    _close(ref_state["kv"][kk], ideal_state["kv"][kk])
            elif key != "index":
                _close(ref_state[key], ideal_state[key])
        assert tapi.backend.summary() == jref.backend.summary()


def _parallel_last_logits(tapi, tparams, toks):
    cfg = tapi.cfg
    x = layers.embed(toks, tparams)
    with torch.inference_mode():
        if cfg.family == "ssm":
            y = tssm.rwkv6_backbone(tparams, x, cfg)
        else:
            y = tssm.zamba2_backbone(tparams, x, cfg)
        return layers.logits_last(y[:, -1:], tparams["embedding"])


@pytest.mark.parametrize("T", [8, 12])          # 12: a ragged chunk
def test_decode_matches_parallel_forward(pair, T):
    """As tests/models/test_consistency.py::test_decode_matches_parallel_
    forward: token-by-token decode_step against the parallel (loss-path)
    forward, last-position logits within 2e-2 of max|logits|."""
    *_, tcfg, tapi, tparams = pair
    toks = torch.from_numpy(np.random.default_rng(16 + T).integers(
        0, tcfg.vocab_size, (1, T)))
    full = _parallel_last_logits(tapi, tparams, toks)
    state = tapi.make_decode_state(ShapeConfig("t", T, 1, "decode"))
    for t in range(T):
        dec, state = tapi.decode_step(tparams, state, toks[:, t:t + 1])
    err = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert err < 2e-2, f"{tcfg.name}: decode/parallel mismatch {err}"


def test_long_ragged_chunk_departs_from_decode_as_the_reference_does():
    """ROADMAP.md C6.  A 100-token prompt is one chunk of 100 (8 does not
    divide it).  With random weights a channel decays by about 1.2 a token,
    so half a chunk's decay passes the +-60 clamp of the centred exponents
    and the chunked form departs from the recurrence: in the JAX package as
    in the port.  The port's parallel forward follows the reference's (run
    op by op, as the decode tests are), and both depart from their decode
    steps by more than test_consistency's 2e-2."""
    from repro.models import layers as jlayers
    jcfg, japi, jparams, tcfg, tapi, tparams = _pair("rwkv6-1.6b")
    T = 100
    toks = np.random.default_rng(18).integers(0, jcfg.vocab_size, (1, T))
    with jax.disable_jit():
        x = jlayers.embed(jnp.asarray(toks), jparams)
        for i in range(jcfg.n_layers):
            x = jssm.rwkv6_block(x, _layer(jparams, "blocks", i), jcfg)
        jfull = jlayers.logits_last(
            jlayers.rmsnorm(x, jparams["final_norm"])[:, -1:],
            jparams["embedding"])
    tfull = _parallel_last_logits(tapi, tparams, torch.from_numpy(toks))
    _close(tfull, jfull)
    jstate = japi.make_decode_state(JShape("t", T, 1, "decode"))
    tstate = tapi.make_decode_state(ShapeConfig("t", T, 1, "decode"))
    jstep = jax.jit(japi.decode_step)
    for t in range(T):
        jdec, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t:t + 1]))
        tdec, tstate = tapi.decode_step(tparams, tstate,
                                        torch.from_numpy(toks[:, t:t + 1]))
    j_gap = float(jnp.abs(jdec - jfull).max() / jnp.abs(jfull).max())
    t_gap = float((tdec - tfull).abs().max() / tfull.abs().max())
    assert j_gap > 2e-2 and t_gap > 2e-2, (j_gap, t_gap)


def test_prefill_raises_as_the_reference_does(pair):
    *_, tapi, tparams = pair
    with pytest.raises(NotImplementedError, match="decode_step"):
        tapi.prefill(tparams, {"tokens": torch.tensor([[3, 4]])})


def test_decode_state_round_trip_and_slot_surgery(pair):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jshape, tshape = JShape("s", 8, 3, "decode"), ShapeConfig("s", 8, 3,
                                                              "decode")
    rng = np.random.default_rng(17)
    jstate = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 4).astype(x.dtype),
        japi.make_decode_state(jshape))
    specs = tapi.decode_state_specs(tshape)
    tstate = decode_state_from_numpy(_np_tree(jstate), specs, "cpu")
    zero = tapi.make_decode_state(tshape)
    assert jax.tree.structure(jstate) == jax.tree.structure(
        jax.tree.map(lambda t: 0, zero))
    for leaf in jax.tree.leaves(zero):
        assert not bool(leaf.any())

    def same(tt, jt):
        for k in jt:
            if isinstance(jt[k], dict):
                same(tt[k], jt[k])
            else:
                assert str(jt[k].dtype) == str(tt[k].dtype).replace(
                    "torch.", ""), k
                assert np.array_equal(_f32(tt[k]), _f32(jt[k])), k

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
    assert tstate2 is tstate
    same(tstate2, jstate2)
    same(tsub, jsub)                          # the slice was a copy
    same(tapi.slot_reset(tshape, tstate, 0),
         japi.slot_reset(jshape, jstate2, 0))


def test_ssm_bf16_loss_and_eight_decode_steps_match_the_reference(
        monkeypatch):
    """cfg.ssm_bf16=True (the bf16 WKV recurrence) on rwkv6 smoke, ideal:
    ``loss`` and eight decode steps against the reference run op by op
    (``jax.disable_jit()``), logits and state within BF16_TOL and the loss
    within 5e-3 relative, tokens by C1's tie rule; every layer's recurrence
    is one wkv6 call on bf16 operands (its plain version's bf16 route on
    CPU tensors).  The loss (24 tokens, chunks of 8) also lies at least 4
    times closer to the reference's bf16 loss than the port's f32
    recurrence's loss does (about 7 times on this batch), so it shows the
    roundings.  The decode steps (s = 1) cannot: there every score is
    masked and the two recurrences are one function; they check the
    routing and the agreement."""
    jcfg, _, jparams, tcfg, _, tparams = _pair("rwkv6-1.6b")
    jcfg = dataclasses.replace(jcfg, ssm_bf16=True)
    tcfg = dataclasses.replace(tcfg, ssm_bf16=True)
    japi, tapi = j_model_api(jcfg), model_api(tcfg, device="cpu")
    calls = []
    real = wkv6_mod.wkv6_plain

    def spy(r, k, v, *args, **kw):
        calls.append((r.dtype, kw["compute_dtype"]))
        return real(r, k, v, *args, **kw)
    monkeypatch.setattr(wkv6_mod, "wkv6_plain", spy)

    rng = np.random.default_rng(15)
    toks = rng.integers(3, jcfg.vocab_size, (2, 24))
    labels = rng.integers(3, jcfg.vocab_size, (2, 24))
    with jax.disable_jit():
        want = float(japi.loss(jparams, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)}))
    got = float(tapi.loss(tparams, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)}))
    assert abs(got - want) <= 5e-3 * abs(want)
    assert calls == [(torch.bfloat16, torch.bfloat16)] * tcfg.n_layers
    f32_api = model_api(dataclasses.replace(tcfg, ssm_bf16=False),
                        device="cpu")
    got32 = float(f32_api.loss(tparams, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)}))
    assert abs(got - want) * 4 <= abs(got32 - want)
    del calls[tcfg.n_layers:]

    jshape, tshape = JShape("s", 16, 2, "decode"), ShapeConfig("s", 16, 2,
                                                              "decode")
    jstate, tstate = japi.make_decode_state(jshape), tapi.make_decode_state(
        tshape)
    toks = np.random.default_rng(0).integers(3, jcfg.vocab_size, (2, 1))
    f32_state = f32_api.make_decode_state(tshape)
    for step in range(8):
        with jax.disable_jit():
            jlog, jstate = japi.decode_step(jparams, jstate, jnp.asarray(toks))
        tlog, _ = tapi.decode_step(tparams, tstate, torch.from_numpy(toks))
        f32_api.decode_step(tparams, f32_state, torch.from_numpy(toks))
        _close(tlog, jlog)
        jl = np.asarray(jlog)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        apart = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL * np.abs(jl).max()
        jtok, ttok = jl.argmax(-1), tlog.argmax(-1).numpy()
        assert np.array_equal(jtok[apart], ttok[apart]), f"step {step}"
        toks = jtok[:, None]
    for key in ("wkv", "prev_att", "prev_ffn"):
        _close(tstate[key], jstate[key])
    # one call a layer of the loss and of each step, the f32 run's beside
    bf16 = (torch.bfloat16, torch.bfloat16)
    assert calls.count(bf16) == tcfg.n_layers * 9
    assert calls.count((torch.float32, torch.float32)) == tcfg.n_layers * 8
