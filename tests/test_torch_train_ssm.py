"""Training the state-space families in the port (rwkv6-1.6b here,
zamba2-2.7b in ``test_torch_train_hybrid.py``), on the CPU: the smoke
config's train step against the JAX package's ``make_train_step`` from the
reference's own initial weights and ``SyntheticDataset`` batches, with the
tolerances of ``tests/test_torch_train.py``:

* five steps on ``ideal``, with the f32 recurrence and (rwkv6) with
  ``cfg.ssm_bf16=True``, the bf16 one: step 0's loss within ``LOSS_RTOL0``, the others
  within ``LOSS_RTOL``; step 0's gradients leaf by leaf within
  ``GRAD_TOL`` of the reference's largest magnitude in the leaf; the
  parameters after step 0 within one bf16 rounding (2 x lr where the two
  gradients can differ in sign).  The reference runs op by op
  (``jax.disable_jit()``, ROADMAP C7).  The recurrences' gradients are the
  port's own backward (``wkv6_backward_plain`` / ``ssd_chunk_backward_plain``
  on the CPU; its bf16 variant for ``ssm_bf16``), the reference's XLA's
  autodiff of its jnp chunked forms;
* one step on ``reference`` (B1's route; the reference compiled: its host
  callbacks can deadlock op by op): the backend's telemetry (GEMM calls,
  MACs, flags) equal to the reference's.  Each block runs again in the
  backward pass (``remat="full"``), but for zamba2's Mamba2 ``out_proj`` and
  shared MLP ``w2``, whose second run XLA drops as dead code;
* the entry points: ``ModelAPI.train_loss``, ``train.train``,
  ``steps.build_train_step`` and ``python -m repro_torch.launch.train``.
  The one-rank mesh step is in ``tests/test_torch_mesh_families.py``.
"""

import contextlib
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro import optim as joptim
from repro.configs import get_config as j_get_config
from repro.models import model_api as j_model_api
from repro.train import make_train_step as j_make_train_step
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models import model_api, params_from_numpy
from repro_torch.models.shardlib import tree_leaves
from repro_torch.train import TrainConfig, make_train_step, train
from test_torch_models import _np_tree
from test_torch_train import (BATCH, GRAD_TOL, LOSS_RTOL, LOSS_RTOL0, LR,
                              SEQ, STEPS, _batches, _f32, _jbatch, _opt,
                              _tbatch)

ARCH = "rwkv6-1.6b"


def five_steps_on_ideal(arch, ssm_bf16=False):
    """The smoke config's five ``ideal`` steps and step 0's gradients
    against the reference's (op by op), both configs with ``ssm_bf16``."""
    jcfg, tcfg = (dataclasses.replace(get(arch, smoke=True), ssm_bf16=ssm_bf16)
                  for get in (j_get_config, get_config))
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    batches = _batches(jcfg)
    japi = j_model_api(jcfg)
    ocfg = joptim.AdamWConfig(**_opt())
    jstep = j_make_train_step(japi, jcfg, ocfg, donate=False)
    with jax.disable_jit():
        _, want_g0 = jax.value_and_grad(japi.loss)(jparams,
                                                   _jbatch(batches[0]))
        p, s = jparams, joptim.init_state(jparams, ocfg)
        want_losses, want_p0 = [], None
        for b in batches:
            p, s, loss = jstep(p, s, _jbatch(b))
            want_losses.append(float(loss))
            want_p0 = p if want_p0 is None else want_p0

    api = model_api(tcfg, device="cpu")
    params = params_from_numpy(_np_tree(jparams), api.param_specs(), "cpu")
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    grads0 = torch.autograd.grad(
        model_api(tcfg, device="cpu").train_loss(params,
                                                 _tbatch(batches[0])),
        leaves)
    for g, j in zip(grads0, jax.tree.leaves(want_g0)):
        g, j = _f32(g), _f32(j)
        assert g.shape == j.shape
        np.testing.assert_allclose(g, j, rtol=0,
                                   atol=GRAD_TOL * np.abs(j).max())
    toc = optim.AdamWConfig(**_opt())
    state = optim.init_state(params, toc)
    step = make_train_step(api, tcfg, toc)
    losses = []
    for i, b in enumerate(batches):
        params, state, loss = step(params, state, _tbatch(b))
        losses.append(float(loss))
        if i == 0:
            for x, j, gj in zip(tree_leaves(params),
                                jax.tree.leaves(want_p0),
                                jax.tree.leaves(want_g0)):
                x, j, gj = _f32(x), _f32(j), _f32(gj)
                diff = np.abs(x - j)
                rounding = 2.0 ** -7 * (np.abs(j) + 2 * LR)
                band = np.abs(gj) <= GRAD_TOL * np.abs(gj).max()
                assert (diff[~band] <= rounding[~band]).all()
                assert (diff <= 2 * LR + rounding).all()
    assert abs(losses[0] - want_losses[0]) <= LOSS_RTOL0 * abs(
        want_losses[0]), (losses, want_losses)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert int(state["step"]) == STEPS


def a_steps_telemetry_on_reference(arch):
    """One ``reference`` step's GEMM calls, MACs and flags against the
    reference's compiled step; the recurrences run their forward twice
    (``remat="full"``) and their backward once a layer."""
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
    rec = {}
    with _counting_calls(rec):
        make_train_step(api, tcfg, toc)(params, optim.init_state(params, toc),
                                        _tbatch(b))
    got = api.backend.summary()
    assert got == japi.backend.summary()
    assert got["flags"] == 0
    # chip_smoke.py's count, which its train_ssm phase holds B1 to
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert got["calls"] == chip_smoke.ssm_train_gemms(tcfg)
    kernel = "wkv6" if tcfg.family == "ssm" else "ssd_chunk"
    assert list(rec) == [kernel] and rec[kernel] == 2 * tcfg.n_layers


@contextlib.contextmanager
def _counting_calls(rec):
    """Count the model's calls of its recurrence (``models/ssm.py``'s
    names), restored on exit."""
    from repro_torch.models import ssm as tssm
    saved = {name: getattr(tssm, name) for name in ("wkv6", "ssd_chunk")}

    def counted(name, fn):
        def call(*a, **kw):
            rec[name] = rec.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    for name, fn in saved.items():
        setattr(tssm, name, counted(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(tssm, name, fn)


def entry_points_train(arch, monkeypatch, capsys):
    """``train_loss`` is differentiable, ``train()`` and the built train
    step run (finite losses), and the launcher trains and prints the
    reference's ``done:`` line."""
    cfg = get_config(arch, smoke=True)
    api = model_api(cfg, device="cpu")
    params = api.init_params(0)
    b = _tbatch(_batches(cfg, 1)[0])
    for x in tree_leaves(params):
        x.requires_grad_(True)
    loss = api.train_loss(params, b)
    assert loss.requires_grad
    assert float(loss.detach()) == float(api.loss(params, b))
    res = train(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                TrainConfig(steps=2, log_every=0, checkpoint_every=0),
                device="cpu")
    assert res.steps_done == 2 and np.isfinite(res.losses).all()
    built = steps.build_train_step(cfg, ShapeConfig("t", SEQ, BATCH,
                                                    "train"), device="cpu")
    params = built.api.init_params(0)
    state = optim.init_state(params, optim.AdamWConfig())
    _, _, loss = built.fn(params, state, b)
    assert np.isfinite(float(loss)) and int(state["step"]) == 1
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", arch, "--smoke", "--steps", "3", "--device",
        "cpu", "--backend", "reference"])
    train_launcher.main()
    out = capsys.readouterr().out
    assert re.search(r"^done: 3 steps in [0-9.]+s; loss ([0-9.]+) -> "
                     r"([0-9.]+)$", out, re.M)


def test_five_steps_match_the_references_train_step():
    five_steps_on_ideal(ARCH)


def test_five_steps_with_ssm_bf16_match_the_references_train_step():
    """rwkv6 with the bf16 recurrence: its gradient through ``wkv6``'s bf16
    backward against ``jax.grad`` of the reference's bf16 form."""
    five_steps_on_ideal(ARCH, ssm_bf16=True)


def test_a_steps_gemm_count_equals_the_references():
    a_steps_telemetry_on_reference(ARCH)


def test_entry_points_train(monkeypatch, capsys):
    entry_points_train(ARCH, monkeypatch, capsys)
