"""The port's AdamW (``repro_torch.optim``) against ``repro.optim``, on the
CPU, from the same numpy parameters and gradients.

Tolerances: with f32 moments, parameters, master weights and moments
within 1e-6 relative of the reference's largest magnitude of the leaf
after each of 10 steps (the same float32 operations in the same order per
element; only the gradient norm sums in another order, which moves the clip
factor in its last bits); int8 moments within one quantization level and
their scales within 1e-6 relative; ``lr_at`` within 1e-6 relative.  The
twins of the reference's own optimizer tests
(``tests/substrate/test_substrates.py``) run on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim
from repro_torch.models.shardlib import ParamSpec, tree_leaves
from repro_torch.optim import adamw

RTOL = 1e-6


def _np_params(seed=0):
    """A small tree: a bf16 stacked matrix, a bf16 matrix, an f32 vector
    (rank 1: an int8 scale spans it whole) and an f32 norm stack."""
    rng = np.random.default_rng(seed)
    bf = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    return {"blocks": {"w": bf(rng.standard_normal((3, 8, 16))),
                       "norm": np.ones((3, 8), np.float32)},
            "emb": bf(0.02 * rng.standard_normal((32, 8))),
            "b": np.zeros((16,), np.float32)}


BF16_KEYS = ("blocks/w", "emb")


def _trees(np_tree, path=""):
    """(jax tree, torch tree) of one numpy tree, bf16 where BF16_KEYS say."""
    if isinstance(np_tree, dict):
        pairs = {k: _trees(v, f"{path}{k}/") for k, v in np_tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    bf16 = path[:-1] in BF16_KEYS
    j = jnp.asarray(np_tree).astype(jnp.bfloat16 if bf16 else jnp.float32)
    t = torch.from_numpy(np_tree.copy()).to(
        torch.bfloat16 if bf16 else torch.float32)
    return j, t


def _grads(step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(
        lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32),
        _np_params())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves_close(got, want, rtol=RTOL):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * max(np.abs(w).max(), 1e-30))


CONFIGS = {
    "f32": dict(lr=1e-2, weight_decay=0.1, warmup_steps=3, total_steps=10),
    "f32_clip": dict(lr=1e-2, grad_clip=0.5, warmup_steps=2,
                     total_steps=10),
    "f32_constant_no_master": dict(lr=5e-3, schedule="constant",
                                   master_fp32=False, grad_clip=0.0),
    "int8": dict(lr=1e-2, int8_moments=True, warmup_steps=3,
                 total_steps=10),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("slice_bytes", [adamw.SLICE_BYTES, 64])
def test_apply_updates_matches_the_reference_over_ten_steps(
        name, slice_bytes, monkeypatch):
    """Ten steps from the same parameters and gradients (gradients of 3x
    the clip, so the clip acts): parameters, masters and moments after
    every step.  ``slice_bytes=64`` walks every leaf two rows of its
    leading axis at a time and must give the same numbers."""
    monkeypatch.setattr(adamw, "SLICE_BYTES", slice_bytes)
    kw = CONFIGS[name]
    jcfg, tcfg = joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    jp, tp = _trees(_np_params())
    js, ts = joptim.init_state(jp, jcfg), optim.init_state(tp, tcfg)
    for step in range(10):
        g = _grads(step, scale=3.0)
        jg, tg = _trees(g)
        jp, js = joptim.apply_updates(jp, js, jg, jcfg)
        tp2, ts2 = optim.apply_updates(tp, ts, tg, tcfg)
        assert tp2 is tp and ts2 is ts          # written in place
        assert int(ts["step"]) == int(js["step"]) == step + 1
        _leaves_close(tp, jp)
        if kw.get("int8_moments"):
            for t_leaf, j_leaf in zip(_state_leaves(ts["per_param"]),
                                      _state_leaves(js["per_param"])):
                for key in ("mu", "nu"):
                    q, jq = t_leaf[key].numpy(), np.asarray(j_leaf[key])
                    assert q.dtype == np.int8
                    assert np.abs(q.astype(int) - jq.astype(int)).max() <= 1
                    s, js_ = (t_leaf[key + "_scale"].numpy(),
                              np.asarray(j_leaf[key + "_scale"]))
                    np.testing.assert_allclose(s, js_, rtol=RTOL, atol=0)
                np.testing.assert_allclose(
                    t_leaf["master"].numpy(), np.asarray(j_leaf["master"]),
                    rtol=0, atol=RTOL * np.abs(j_leaf["master"]).max())
        else:
            _leaves_close(ts["per_param"], js["per_param"])


def _state_leaves(tree):
    if "mu" in tree:
        return [tree]
    return [leaf for k in sorted(tree) for leaf in _state_leaves(tree[k])]


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_the_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    jcfg, tcfg = joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    for s in range(0, 120, 3):
        got = optim.lr_at(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = float(joptim.lr_at(jcfg, jnp.int32(s)))
        assert abs(float(got) - want) <= RTOL * abs(want), (s, got, want)
    assert float(optim.lr_at(tcfg, 5)) == float(
        optim.lr_at(tcfg, torch.tensor(5)))


def test_global_norm_and_quantizer_match_the_reference():
    jg, tg = _trees(_grads(0))
    got, want = float(optim.global_norm(tg)), float(joptim.global_norm(jg))
    assert abs(got - want) <= RTOL * want
    x = np.random.default_rng(3).standard_normal((5, 33)).astype(np.float32)
    x[1] = 0.0
    q, s = optim.quantize_i8(torch.from_numpy(x))
    jq, js = joptim.quantize_i8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)
                  ).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL)
    np.testing.assert_array_equal(
        optim.dequantize_i8(optim.Quantized(q, s)).numpy(),
        q.numpy().astype(np.float32) * s.numpy())


@pytest.mark.parametrize("int8", [False, True])
def test_state_specs_mirror_the_references(int8):
    jcfg, tcfg = (joptim.AdamWConfig(int8_moments=int8),
                  optim.AdamWConfig(int8_moments=int8))
    from repro.models.shardlib import ParamSpec as JParamSpec
    specs = {"w": ((4, 8), ("fsdp", "tp")), "n": ((8,), (None,))}
    tspecs = optim.state_specs(
        {k: ParamSpec(s, torch.bfloat16, lg) for k, (s, lg) in specs.items()},
        tcfg)
    jspecs = joptim.state_specs(
        {k: JParamSpec(s, jnp.bfloat16, lg) for k, (s, lg) in specs.items()},
        jcfg)
    assert tspecs["step"].shape == () and tspecs["step"].dtype == torch.int32
    for k in specs:
        t, j = tspecs["per_param"][k], jspecs["per_param"][k]
        assert sorted(t) == sorted(j)
        for key in t:
            assert t[key].shape == j[key].shape
            assert t[key].logical == j[key].logical
            assert str(t[key].dtype).replace("torch.", "") == str(
                jnp.dtype(j[key].dtype))
    tp = {"w": torch.ones(4, 8, dtype=torch.bfloat16)}
    st = optim.init_state(tp, tcfg)
    assert st["per_param"]["w"]["master"].dtype == torch.float32
    assert st["per_param"]["w"]["master"].data_ptr() != tp["w"].data_ptr()


def test_a_gradient_of_none_counts_as_zeros():
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1)
    _, tp = _trees(_np_params())
    _, tp2 = _trees(_np_params())
    _, tg = _trees(_grads(0))
    tg["b"] = None
    tg2 = dict(tg, b=torch.zeros(16))
    optim.apply_updates(tp, optim.init_state(tp, cfg), tg, cfg)
    optim.apply_updates(tp2, optim.init_state(tp2, cfg), tg2, cfg)
    for a, b in zip(tree_leaves(tp), tree_leaves(tp2)):
        assert torch.equal(a, b)


# ---- twins of tests/substrate/test_substrates.py's optimizer tests -----------

def _tiny_params():
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn((8, 16), generator=gen).to(torch.bfloat16),
            "b": torch.zeros((16,), dtype=torch.float32)}


def test_adamw_descends_quadratic():
    cfg = optim.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                            schedule="constant")
    params = _tiny_params()
    state = optim.init_state(params, cfg)

    def loss_fn(p):
        return sum(torch.sum((a.to(torch.float32) - 1.0) ** 2)
                   for a in tree_leaves(p))

    l0 = float(loss_fn(params))
    for _ in range(60):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        tree = dict(zip(sorted(params), leaves))
        grads = dict(zip(sorted(params),
                         torch.autograd.grad(loss_fn(tree), leaves)))
        params, state = optim.apply_updates(params, state, grads, cfg)
    assert float(loss_fn(params)) < 0.1 * l0
    assert int(state["step"]) == 60


def test_adamw_grad_clip():
    cfg = optim.AdamWConfig(lr=1e-3, grad_clip=1.0)
    params = _tiny_params()
    before = {k: v.clone() for k, v in params.items()}
    state = optim.init_state(params, cfg)
    huge = {k: 1e6 * torch.ones(v.shape) for k, v in params.items()}
    optim.apply_updates(params, state, huge, cfg)
    delta = max(float((params[k].float() - before[k].float()).abs().max())
                for k in params)
    assert delta < 0.1            # clip bounded the update


def test_adamw_int8_moments_roughly_match_fp32():
    g = {k: 0.01 * torch.ones(v.shape) for k, v in _tiny_params().items()}
    cfg32 = optim.AdamWConfig(lr=0.01, int8_moments=False, weight_decay=0.0)
    cfg8 = optim.AdamWConfig(lr=0.01, int8_moments=True, weight_decay=0.0)
    p32, p8 = _tiny_params(), _tiny_params()
    s32, s8 = optim.init_state(p32, cfg32), optim.init_state(p8, cfg8)
    for _ in range(10):
        optim.apply_updates(p32, s32, g, cfg32)
        optim.apply_updates(p8, s8, g, cfg8)
    for k in p32:
        np.testing.assert_allclose(p32[k].float().numpy(),
                                   p8[k].float().numpy(), atol=5e-3)
    # compression is real: moments stored as int8
    assert s8["per_param"]["w"]["mu"].dtype == torch.int8


def test_lr_schedule():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(optim.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6
    assert lrs[99] < lrs[50] < lrs[12]
