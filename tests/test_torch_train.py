"""The port's training slice (``repro_torch.train``, ``launch.steps``,
``launch.train``, ``ModelAPI.train_loss`` / ``input_specs``) against the
JAX package's, on the CPU, from the reference's own initial weights
converted leaf by leaf and the same ``SyntheticDataset`` batches.

Tolerances, stated before they were measured against:

* ``_Routed`` (the backend's straight-through GEMM) against ``jax.grad``
  through the reference's ``traced_matmul`` on ``reference`` (jitted): both
  backward products are ``(g @ b.T)`` and ``(a.T @ g)`` rounded once to the
  operand's dtype, from sums in another order: within 1e-5 of the largest
  magnitude in f32, and one bf16 rounding (2^-8) in bf16.
* Step 0's loss within ``LOSS_RTOL0`` = 1e-4 relative; the next four within
  ``LOSS_RTOL`` = 2e-3.  AdamW's first steps are nearly sign updates
  (``m / sqrt(v)``), so where the two stacks' bf16 gradients lie within
  rounding of zero their signs differ and that parameter moves by 2 x lr
  the other way; those few moves shift the later losses.
* Step 0's gradients, leaf by leaf, within ``GRAD_TOL`` = 2 x ``BF16_TOL``
  of the reference's largest magnitude in the leaf: a weight's gradient is
  a bf16 product of cotangents that went through the forward's roundings
  and as many again on the way back.
* The parameters after step 0: within one bf16 rounding of the
  reference's where the reference's step-0 gradient lies outside the
  gradients' band of agreement (``GRAD_TOL`` of the leaf's largest
  magnitude); inside it, within 2 x lr plus one rounding: there the two
  gradients can differ in sign, or be small enough next to AdamW's eps
  that the update is not a sign.
* The backend's telemetry (GEMM calls, MACs, flags) after five steps equal
  to the reference's jitted ``reference`` run: the port recomputes each
  block in the backward pass as ``jax.checkpoint`` does, and keeps the
  MLP's down projection out of it, as XLA's dead-code pass does.

The reference runs its ``ideal`` backend op by op (``jax.disable_jit()``,
ROADMAP C7) and its ``reference`` backend compiled only: its host callback
dispatches JAX operations, which can deadlock against op-by-op dispatch.
"""

import contextlib
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.backend import get_backend as j_get_backend
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.models import model_api as j_model_api
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro.train import train as j_train
from repro_torch import optim
from repro_torch.backend import get_backend, use_backend
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models import model_api, params_from_numpy
from repro_torch.models.shardlib import tree_leaves
from repro_torch.train import TrainConfig, make_train_step, train
from test_torch_models import BF16_TOL, _np_tree

LOSS_RTOL0, LOSS_RTOL = 1e-4, 2e-3
GRAD_TOL = 2 * BF16_TOL
BATCH, SEQ, STEPS, LR = 4, 32, 5, 1e-3
PARITY_ARCHS = ("phi4-mini-3.8b", "grok-1-314b", "llava-next-mistral-7b",
                "seamless-m4t-medium")


def _opt():
    return dict(lr=LR, warmup_steps=1, total_steps=STEPS)


def _batches(cfg, n=STEPS):
    """The trainer's batches for steps 0..n-1 (its data config, vision
    trim), numpy."""
    ds = JSyntheticDataset(JDataConfig(
        vocab_size=cfg.padded_vocab, seq_len=SEQ, global_batch=BATCH,
        seed=0, mean_doc_len=max(SEQ // 8, 8), frontend=cfg.frontend,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
        enc_frames_ratio=cfg.enc_frames_ratio))
    out = []
    for step in range(n):
        b = ds.batch_at(step).data
        if cfg.frontend == "vision":
            p = min(cfg.frontend_tokens, SEQ // 2)
            b = {"patch_embeds": b["patch_embeds"][:, :p],
                 "tokens": b["tokens"][:, :SEQ - p],
                 "labels": b["labels"][:, :SEQ - p]}
        out.append(b)
    return out


def _jbatch(b):
    out = {k: jnp.asarray(v) for k, v in b.items()}
    if "patch_embeds" in out:
        out["patch_embeds"] = out["patch_embeds"].astype(jnp.bfloat16)
    return out


def _tbatch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if "patch_embeds" in out:
        out["patch_embeds"] = out["patch_embeds"].to(torch.bfloat16)
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the straight-through GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b_view", ["plain", "transposed"])
def test_routed_gradients_equal_jax_grad_through_traced_matmul(dtype,
                                                               b_view):
    """``reference``'s routed GEMM under autograd: forward equal to the
    reference's, and the gradients of both operands (``b`` reached through
    a transposed view, as the logits reach ``emb.T``) equal to ``jax.grad``
    through the reference's ``traced_matmul`` (jitted)."""
    rng = np.random.default_rng(5)
    m, k, n = 12, 40, 24
    a = rng.standard_normal((m, k)).astype(np.float32)
    store = rng.standard_normal((n, k) if b_view == "transposed"
                                else (k, n)).astype(np.float32)
    w = rng.standard_normal((m, n)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jbe = j_get_backend("reference")

    def jloss(a, s):
        b = s.T if b_view == "transposed" else s
        out = jbe.traced_matmul(a, b)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, jout), (ja, js) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jnp.asarray(a).astype(jdt), jnp.asarray(store).astype(jdt))
    be = get_backend("reference", device="cpu")
    ta = torch.from_numpy(a).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(store).to(tdt).requires_grad_(True)
    tb = ts.T if b_view == "transposed" else ts
    out = be.traced_matmul(ta, tb)
    assert out.dtype == tdt
    ga, gs = torch.autograd.grad(
        torch.sum(out.to(torch.float32) * torch.from_numpy(w)), (ta, ts))
    assert ga.dtype == tdt and gs.dtype == tdt
    assert gs.shape == ts.shape
    tol = 2.0 ** -8 if dtype == "bfloat16" else 1e-5
    for got, want in ((out, jout), (ga, ja), (gs, js)):
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, rtol=0,
                                   atol=tol * np.abs(want).max())
    assert be.summary()["calls"] == 1 == jbe.summary()["calls"]


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_the_references(arch, kind):
    jspecs = j_model_api(j_get_config(arch)).input_specs(
        JShape("t", 64, 4, kind))
    tspecs = model_api(get_config(arch), device="cpu").input_specs(
        ShapeConfig("t", 64, 4, kind))
    assert sorted(tspecs) == sorted(jspecs)
    for k, t in tspecs.items():
        j = jspecs[k]
        assert t.shape == j.shape and t.logical == j.logical
        assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
        s = t.struct()
        assert s.device.type == "meta" and tuple(s.shape) == t.shape
        assert s.dtype == t.dtype


# ---------------------------------------------------------------------------
# five training steps against the reference's make_train_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=PARITY_ARCHS)
def parity_case(request):
    arch = request.param
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, _batches(jcfg)


def _reference_run(jcfg, jparams, batches, backend):
    """The reference's five steps (losses, parameters after step 0, step
    0's gradients, backend summary); ``ideal`` op by op, ``reference``
    compiled."""
    be = None if backend == "ideal" else backend
    api = j_model_api(jcfg, backend=be)
    ocfg = joptim.AdamWConfig(**_opt())
    step = j_make_train_step(api, jcfg, ocfg, donate=False)
    grad_fn = jax.value_and_grad(j_model_api(jcfg, backend=be).loss)
    mode = contextlib.nullcontext()
    if backend == "ideal":
        mode = jax.disable_jit()
    else:
        grad_fn = jax.jit(grad_fn)
    with mode:
        _, grads0 = grad_fn(jparams, _jbatch(batches[0]))
        p, s = jparams, joptim.init_state(jparams, ocfg)
        losses, after0 = [], None
        for b in batches:
            p, s, loss = step(p, s, _jbatch(b))
            losses.append(float(loss))
            after0 = p if after0 is None else after0
    return (losses, after0, grads0,
            api.backend.summary() if api.backend is not None else None)


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_five_steps_match_the_references_train_step(parity_case, backend):
    jcfg, tcfg, jparams, batches = parity_case
    want_losses, want_p0, want_g0, want_summary = _reference_run(
        jcfg, jparams, batches, backend)

    api = model_api(tcfg, backend=backend, device="cpu")
    params = params_from_numpy(_np_tree(jparams), api.param_specs(), "cpu")
    # step 0's gradients (through an API of their own: `api` counts steps)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    grads0 = torch.autograd.grad(
        model_api(tcfg, backend=backend, device="cpu").train_loss(
            params, _tbatch(batches[0])), leaves)
    for g, j in zip(grads0, jax.tree.leaves(want_g0)):
        g, j = _f32(g), _f32(j)
        assert g.shape == j.shape
        np.testing.assert_allclose(g, j, rtol=0,
                                   atol=GRAD_TOL * np.abs(j).max())
    # five steps
    ocfg = optim.AdamWConfig(**_opt())
    state = optim.init_state(params, ocfg)
    step = make_train_step(api, tcfg, ocfg)
    losses = []
    for i, b in enumerate(batches):
        params, state, loss = step(params, state, _tbatch(b))
        assert loss.dtype == torch.float32 and not loss.requires_grad
        losses.append(float(loss))
        if i == 0:
            for p, j, gj in zip(tree_leaves(params),
                                jax.tree.leaves(want_p0),
                                jax.tree.leaves(want_g0)):
                p, j, gj = _f32(p), _f32(j), _f32(gj)
                diff = np.abs(p - j)
                rounding = 2.0 ** -7 * (np.abs(j) + 2 * LR)
                band = np.abs(gj) <= GRAD_TOL * np.abs(gj).max()
                assert (diff[~band] <= rounding[~band]).all()
                assert (diff <= 2 * LR + rounding).all()
    assert abs(losses[0] - want_losses[0]) <= LOSS_RTOL0 * abs(
        want_losses[0]), (losses, want_losses)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert int(state["step"]) == STEPS
    if backend == "reference":
        got = api.backend.summary()
        assert got["calls"] % STEPS == 0
        assert got == want_summary
        assert got["flags"] == 0


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "starcoder2-3b"])
def test_a_steps_gemm_count_equals_the_references(arch):
    """The other MoE config (a shared expert, whose down projection the
    recomputation skips) and a gelu MLP: one step's GEMM calls and MACs
    equal the reference's compiled ``reference`` step's."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    b = _batches(jcfg, 1)[0]
    japi = j_model_api(jcfg, backend="reference")
    ocfg = joptim.AdamWConfig(**_opt())
    j_make_train_step(japi, jcfg, ocfg, donate=False)(
        jparams, joptim.init_state(jparams, ocfg), _jbatch(b))
    api = model_api(tcfg, backend="reference", device="cpu")
    params = params_from_numpy(_np_tree(jparams), api.param_specs(), "cpu")
    toc = optim.AdamWConfig(**_opt())
    make_train_step(api, tcfg, toc)(params, optim.init_state(params, toc),
                                    _tbatch(b))
    assert api.backend.summary() == japi.backend.summary()


def test_init_params_makes_tensors_autograd_accepts():
    """Parameters are made outside ``inference_mode`` (autograd refuses
    inference tensors), and ``loss`` stays a forward pass under it."""
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    api = model_api(cfg, device="cpu")
    params = api.init_params(0)
    assert not any(p.is_inference() for p in tree_leaves(params))
    b = _tbatch(_batches(cfg, 1)[0])
    assert not api.loss(params, b).requires_grad
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = api.train_loss(params, b)
    assert loss.requires_grad
    assert float(loss.detach()) == float(api.loss(params, b))


def test_remat_recomputes_the_same_numbers():
    """``remat="none"`` runs each GEMM once and gives the gradients of
    ``"full"`` bit for bit; "full" runs the block heads twice."""
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    b = _tbatch(_batches(cfg, 1)[0])
    out = {}
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        api = model_api(c, backend="reference", device="cpu")
        params = api.init_params(0, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        out[remat] = (torch.autograd.grad(api.train_loss(params, b), leaves),
                      api.backend.summary()["calls"])
    L = cfg.n_layers
    assert out["none"][1] == 7 * L + 1
    assert out["full"][1] == 7 * L + 1 + 6 * L
    for g, h in zip(out["full"][0], out["none"][0]):
        assert torch.equal(g, h)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
def test_train_matches_the_references_train(arch):
    """``train()`` from the reference's weights (``init=``) against the
    reference's ``train()`` (compiled, ``ideal``): the vision trim and the
    encdec frames go through the loop; the loss curves within LOSS_RTOL."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    shape = JShape("t", SEQ, BATCH, "train")
    tc = dict(steps=STEPS, log_every=0, checkpoint_every=0)
    want = j_train(jcfg, shape, JTrainConfig(**tc), joptim.AdamWConfig(
        **_opt()))
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    got = train(tcfg, ShapeConfig("t", SEQ, BATCH, "train"),
                TrainConfig(**tc), optim.AdamWConfig(**_opt()),
                device="cpu", init=lambda api: params_from_numpy(
                    _np_tree(jparams), api.param_specs(), "cpu"))
    assert got.steps_done == want.steps_done == STEPS
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
    assert int(got.final_opt_state["step"]) == STEPS


def test_train_loss_decreases_and_resumes(tmp_path):
    """Twin of the reference's test of the same name."""
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    shape = ShapeConfig("t", 32, 4, "train")
    tc = TrainConfig(steps=16, log_every=0, checkpoint_every=8,
                     checkpoint_dir=str(tmp_path), async_checkpoint=False)
    res = train(cfg, shape, tc, optim.AdamWConfig(lr=5e-3, warmup_steps=2,
                                                  total_steps=16),
                device="cpu")
    assert res.steps_done == 16
    assert np.isfinite(res.losses).all()
    assert np.mean(res.losses[-4:]) < np.mean(res.losses[:4]) - 0.05

    # crash/restart: resume from step 16 checkpoint, run to 20
    tc2 = dataclasses.replace(tc, steps=20)
    res2 = train(cfg, shape, tc2, optim.AdamWConfig(lr=5e-3, warmup_steps=2,
                                                    total_steps=16),
                 resume=True, device="cpu")
    assert res2.steps_done == 4                     # resumed, not restarted


def test_train_resume_bit_identical(tmp_path):
    """Twin of the reference's test: an uninterrupted 6-step run == (4
    steps, crash, resume 2 steps), with the async checkpoint of the
    trainer's default."""
    cfg = get_config("starcoder2-3b", smoke=True)
    shape = ShapeConfig("t", 32, 4, "train")
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)

    straight = train(cfg, shape,
                     TrainConfig(steps=6, log_every=0, checkpoint_every=0),
                     ocfg, device="cpu")
    train(cfg, shape, TrainConfig(steps=4, log_every=0, checkpoint_every=4,
                                  checkpoint_dir=str(tmp_path)),
          ocfg, device="cpu")
    part2 = train(cfg, shape,
                  TrainConfig(steps=6, log_every=0, checkpoint_every=0,
                              checkpoint_dir=str(tmp_path)), ocfg,
                  resume=True, device="cpu")
    np.testing.assert_allclose(straight.losses[4:], part2.losses, rtol=1e-5)


def test_train_under_reference_counts_every_gemm_and_no_flag():
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    be = get_backend("reference", device="cpu")
    with use_backend(be):
        res = train(cfg, ShapeConfig("t", 32, 4, "train"),
                    TrainConfig(steps=2, log_every=0, checkpoint_every=0),
                    device="cpu")
    L = cfg.n_layers
    assert be.summary()["calls"] == 2 * (13 * L + 1)
    assert be.summary()["flags"] == 0 and np.isfinite(res.losses).all()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_ssm_bf16_trains_through_every_entry_point(arch, monkeypatch):
    """``ssm_bf16=True`` trains through the four entry points, one smoke
    step each (``train``, ``make_train_step``, ``steps.build_train_step``,
    ``ModelAPI.train_loss``): finite losses and gradients.  rwkv6 takes the
    bf16 recurrence's gradient (``wkv6_backward_plain`` in bf16, once a
    layer); zamba2, whose Mamba2 path reads no ``ssm_bf16`` in either
    package, gives the bits of ``ssm_bf16=False``."""
    from repro_torch.kernels import wkv6 as wmod
    seen = []
    real = wmod.wkv6_backward_plain

    def spy(*args, **kw):
        seen.append(kw["compute_dtype"])
        return real(*args, **kw)
    monkeypatch.setattr(wmod, "wkv6_backward_plain", spy)
    shape = ShapeConfig("t", 32, 4, "train")
    base = get_config(arch, smoke=True)
    b = _tbatch(_batches(base, 1)[0])
    runs = {}
    for flag in (False, True):
        cfg = dataclasses.replace(base, ssm_bf16=flag)
        api = model_api(cfg, device="cpu")
        res = train(cfg, shape, TrainConfig(steps=1, log_every=0,
                                            checkpoint_every=0),
                    device="cpu")
        params = api.init_params(0)
        state = optim.init_state(params, optim.AdamWConfig())
        _, _, loss1 = make_train_step(api, cfg, optim.AdamWConfig())(
            params, state, b)
        built = steps.build_train_step(cfg, shape, device="cpu")
        params2 = built.api.init_params(0)
        _, _, loss2 = built.fn(params2, optim.init_state(
            params2, optim.AdamWConfig()), b)
        params3 = api.init_params(0)
        leaves = tree_leaves(params3)
        for x in leaves:
            x.requires_grad_(True)
        seen.clear()
        grads = torch.autograd.grad(api.train_loss(params3, b), leaves)
        losses = res.losses + [float(loss1), float(loss2)]
        assert np.isfinite(losses).all()
        assert all(torch.isfinite(g.float()).all() for g in grads)
        if cfg.family == "ssm":
            want = torch.bfloat16 if flag else torch.float32
            assert seen == [want] * cfg.n_layers
        runs[flag] = (losses, tree_leaves(params), tree_leaves(params2),
                      grads)
    (l0, p0, q0, g0), (l1, p1, q1, g1) = runs[False], runs[True]
    if arch == "zamba2-2.7b":
        assert l0 == l1
        for x, y in zip(p0 + q0 + list(g0), p1 + q1 + list(g1)):
            assert torch.equal(x, y)
    else:
        assert any(not torch.equal(x, y) for x, y in zip(g0, g1))


def test_launcher_trains_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "phi4-mini-3.8b", "--smoke", "--steps", "4",
        "--device", "cpu", "--backend", "reference"])
    train_launcher.main()
    out = capsys.readouterr().out
    m = re.search(r"^done: 4 steps in [0-9.]+s; loss ([0-9.]+) -> "
                  r"([0-9.]+)$", out, re.M)
    assert m and float(m.group(2)) < float(m.group(1))


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def test_step_builders_on_one_device():
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    shape = ShapeConfig("t", 32, 4, "train")
    built = steps.build_train_step(cfg, shape, device="cpu")
    assert built.kind == "train" and built.rules is None
    pstructs, ostructs, bstructs = built.arg_structs
    params = built.api.init_params(0)
    assert [tuple(s.shape) for s in tree_leaves(pstructs)] == [
        tuple(p.shape) for p in tree_leaves(params)]
    assert all(s.device.type == "meta" for s in tree_leaves(ostructs))
    assert tuple(bstructs["tokens"].shape) == (4, 32)
    state = optim.init_state(params, optim.AdamWConfig())
    b = _tbatch(_batches(cfg, 1)[0])
    _, _, loss = built.fn(params, state, b)
    assert np.isfinite(float(loss)) and int(state["step"]) == 1
    decode = steps.build_decode_step(cfg, ShapeConfig("d", 16, 2, "decode"),
                                     device="cpu")
    assert tuple(decode.arg_structs[2].shape) == (2, 1)
    prefill = steps.build_prefill_step(cfg, ShapeConfig("p", 16, 2,
                                                        "prefill"),
                                       device="cpu")
    logits, _ = prefill.fn(params, {"tokens": b["tokens"][:2, :16]})
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    fwd = steps.build_forward_step(cfg, shape, device="cpu")
    assert float(fwd.fn(params, b)) == float(built.api.loss(params, b))
    # one device: the step lowers (traced without data) with no
    # collectives; rules are a Rules or None (meshes: test_torch_mesh.py)
    lowered = built.lower()
    assert lowered.kind == "train" and lowered.collectives == []
    assert lowered.cost["flops"] > 0 and lowered.memory["argument_bytes"] > 0
    assert decode.lower().memory["alias_bytes"] > 0
    with pytest.raises(TypeError, match="Rules"):
        steps.build_train_step(cfg, shape, rules=object(), device="cpu")
