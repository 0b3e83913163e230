"""Train steps of every model family not yet held on a 4-rank mesh, on the
CPU.

On a ``gloo`` (2, 2) ("data", "model") mesh of 4 ranks (one process a rank,
spawned once for every config), one AdamW step (lr = 1e-3) of grok and
llama4 (MoE), llava (VLM, seeded patch embeddings), seamless
(encoder-decoder, seeded frames), granite (MQA), starcoder2 and qwen (qkv
bias), each through ``build_cell(arch, ShapeConfig("t", 32, 4, "train"))``
on ``reference``, by ``test_torch_mesh.py``'s tolerances, stated there
before they were measured against:

* against the port's ``rules=None`` step from the same ``init_params(0)``
  weights: the loss within ``LOSS_RTOL``; step 0's gradients, their global
  norm and the parameters after the step by ``_assert_step0_agrees``; and
  each rank routes the step's GEMMs through the backend once each, as the
  unsharded step does.  llama4 routes one expert a token (top_k = 1): its
  renormalised gate is p / p = 1 whatever the router's logits, so the
  router's gradient is zero in exact arithmetic and both runs give rounding
  noise there (about 5e-10).  That leaf is held by an absolute bound,
  ``ROUTER_ABS`` = 1e-8, and its parameters by the band rule's inside case
  (within 2 lr and one rounding); ``test_torch_mesh.py`` holds the router's
  gradient at top_k = 2;
* against the JAX package's jitted step and ``jax.grad`` on its own (2, 2)
  mesh, from its ``init_params(PRNGKey(0))`` weights, for grok (top-2 MoE)
  and seamless (the encoder-decoder's first mesh): the same tolerances, on
  the trainer's step-0 batch (``SyntheticDataset``, seed 0), on which
  ``test_torch_train.py`` holds both archs' unsharded steps to the
  reference's.  Across the two stacks a routing near-tie sends a token to
  another expert (C11): on the seeded batch of the other tests grok's
  unsharded step-0 gradients already leave the reference's by up to 26 %
  of a leaf's largest magnitude.
"""

import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model_api as j_model_api
from repro_torch import optim
from repro_torch.backend import get_backend, use_backend
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.models import model_api, params_from_numpy
from repro_torch.models.shardlib import tree_map
from repro_torch.train import make_train_step
from test_torch_mesh import (_GRADS0, _JAX_TRAIN, LOSS_RTOL, LR,
                             _assert_step0_agrees, _finish, _flat, _grads0,
                             _np64, _spawn)
from test_torch_mesh_families import _batch
from test_torch_models import _np_tree

ARCHS = ("grok-1-314b", "llama4-scout-17b-a16e", "llava-next-mistral-7b",
         "seamless-m4t-medium", "granite-20b", "starcoder2-3b",
         "qwen1.5-110b")
JAX_ARCHS = ("grok-1-314b", "seamless-m4t-medium")
BATCH, SEQ = 4, 32
ROUTER_ABS = 1e-8

_RANK = textwrap.dedent(_GRADS0) + textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)            # four ranks share the host's cores
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    from repro_torch import optim
    from repro_torch.backend import get_backend, use_backend
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import start_mesh, stop_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.shardlib import distribute_tree, tree_map
    inputs = torch.load(f"{tmp}/inputs.pt", weights_only=True)
    mesh = start_mesh((2, 2), ("data", "model"), backend="gloo", rank=rank,
                      store_path=f"{tmp}/store")
    ocfg = optim.AdamWConfig(lr=inputs["lr"], warmup_steps=1, total_steps=5)
    b, s = inputs["shape"]
    out = {}
    for key, run in inputs["runs"].items():
        cell = build_cell(run["arch"], ShapeConfig("t", s, b, "train"), mesh,
                          smoke=True, opt_cfg=ocfg)
        specs = cell.api.param_specs()
        state = distribute_tree(optim.init_state(run["params"], ocfg),
                                optim.state_specs(specs, ocfg), cell.rules)
        params = distribute_tree(run["params"], specs, cell.rules)
        with use_backend(get_backend("reference", device="cpu")):
            grads, gnorm = grads0(cell.api, params, run["batch"], cell.rules)
        be = get_backend("reference", device="cpu")
        with use_backend(be):
            _, state, loss = cell.fn(params, state, run["batch"])
        out[key] = {"loss": float(loss), "grads": grads, "gnorm": gnorm,
                    "params": tree_map(lambda t: t.full_tensor(), params),
                    "calls": be.summary()["calls"]}
    if rank == 0:
        torch.save(out, f"{tmp}/port.pt")
    stop_mesh()
""")


def _jax_weights(arch, api):
    jparams = j_model_api(j_get_config(arch, smoke=True)).init_params(
        jax.random.PRNGKey(0))
    return params_from_numpy(_np_tree(jparams), api.param_specs(), "cpu")


def _trainer_batch(cfg):
    """The trainer's step-0 batch (``test_torch_train.py``'s)."""
    ds = SyntheticDataset(DataConfig(
        vocab_size=cfg.padded_vocab, seq_len=SEQ, global_batch=BATCH,
        seed=0, mean_doc_len=max(SEQ // 8, 8), frontend=cfg.frontend,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
        enc_frames_ratio=cfg.enc_frames_ratio))
    return {k: torch.from_numpy(v) for k, v in ds.batch_at(0).data.items()}


def _jax_run(tmp, arch, batch):
    """The reference's step on its own (2, 2) mesh, in a process of its own
    with 4 host devices."""
    where = tmp / arch
    where.mkdir()
    np.savez(where / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    return where, _spawn(_JAX_TRAIN, (where, LR, arch), devices=4)


def _jax_out(where):
    jout = np.load(where / "jax.npz")
    ref = {"loss": float(jout["loss"]), "gnorm": float(jout["gnorm"])}
    for part in ("param", "grad"):
        ref[part + "s"] = {k.split(":", 1)[1]: jout[k] for k in jout.files
                           if k.startswith(part + ":")}
    return ref


@pytest.fixture(scope="module")
def mesh_train_families(tmp_path_factory):
    """Per arch: the 4-rank mesh's step from ``init_params(0)`` and the
    ``rules=None`` step; for ``JAX_ARCHS`` also the mesh's step from the
    reference's weights and the reference's own mesh step."""
    tmp = tmp_path_factory.mktemp("mesh_train_families")
    runs, apis = {}, {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        apis[arch] = model_api(cfg, device="cpu")
        runs[arch] = {"arch": arch, "params": apis[arch].init_params(0),
                      "batch": _batch(cfg, BATCH, SEQ)}
    jax_procs = {}
    for arch in JAX_ARCHS:
        batch = _trainer_batch(apis[arch].cfg)
        runs[f"{arch}@jax"] = {"arch": arch, "batch": batch,
                               "params": _jax_weights(arch, apis[arch])}
        jax_procs[arch] = _jax_run(tmp, arch, batch)
    torch.save({"runs": runs, "lr": LR, "shape": (BATCH, SEQ)},
               tmp / "inputs.pt")
    procs = [_spawn(_RANK, (rank, tmp)) for rank in range(4)]
    ocfg = optim.AdamWConfig(lr=LR, warmup_steps=1, total_steps=5)
    alone = {}
    for arch in ARCHS:
        api, run = apis[arch], runs[arch]
        p = tree_map(lambda t: t.clone(), run["params"])
        with use_backend("reference", device="cpu"):
            grads, gnorm = _grads0(api, p, run["batch"], None)
        be = get_backend("reference", device="cpu")
        with use_backend(be):
            _, _, loss = make_train_step(api, api.cfg, ocfg)(
                p, optim.init_state(p, ocfg), run["batch"])
        alone[arch] = {"loss": float(loss), "grads": _flat(grads),
                       "params": _flat(p), "gnorm": gnorm,
                       "calls": be.summary()["calls"]}
    _finish(procs + [proc for _, proc in jax_procs.values()])
    ref = {arch: _jax_out(where) for arch, (where, _) in jax_procs.items()}
    return torch.load(tmp / "port.pt", weights_only=True), alone, ref


def _router_apart(got, want):
    """Take the top_k = 1 router leaf out of ``got`` and ``want`` and hold
    it by ``ROUTER_ABS`` (gradient) and the band rule's inside case
    (parameters after the step)."""
    got = {**got, "grads": _flat(got["grads"]),
           "params": _flat(got["params"])}
    want = {**want, "grads": dict(want["grads"]),
            "params": dict(want["params"])}
    keys = [k for k in want["grads"] if k.endswith("router")]
    assert keys
    for key in keys:
        g, wg = _np64(got["grads"].pop(key)), _np64(want["grads"].pop(key))
        assert g.shape == wg.shape and np.abs(wg).max() < ROUTER_ABS
        assert np.abs(g - wg).max() <= ROUTER_ABS, key
        p, w = (_np64(got["params"].pop(key)),
                _np64(want["params"].pop(key)))
        assert (np.abs(p - w) <= 2 * LR + 2.0 ** -7 * (np.abs(w) + 2 * LR)
                ).all(), key
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_a_4_rank_mesh_matches_no_mesh(mesh_train_families,
                                                     arch):
    meshed, alone, _ = mesh_train_families
    got, want = meshed[arch], alone[arch]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    if get_config(arch, smoke=True).top_k == 1:
        got, want = _router_apart(got, want)
    _assert_step0_agrees(got, want)
    # every rank routes every GEMM of the step through the backend once
    # (its local block), as unsharded
    assert got["calls"] == want["calls"] > 0


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_train_step_on_a_4_rank_mesh_matches_the_reference_mesh(
        mesh_train_families, arch):
    meshed, _, ref = mesh_train_families
    got, want = meshed[f"{arch}@jax"], ref[arch]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    _assert_step0_agrees(got, want)
