"""The port's device mesh (``models.shardlib`` rules, ``launch.mesh``,
``launch.steps`` on a mesh, ``layers.moe_ep_a2a``, the optimizer and
checkpoints on ``DTensor`` leaves) against the JAX package's, on the CPU.

Process groups: a ``gloo`` group of 4 ranks (each rank its own process,
``_PORT_RANK``) for numbers, one of 1 rank in this process for bit
equality, and ``fake`` groups of up to 8 ranks for tracing without data.
The JAX package runs its mesh in a subprocess that forces 4 or 8 XLA host
devices, as ``tests/distributed/test_distributed.py`` does.

Tolerances, stated before they were measured against:

* Rules: the resolved specs equal the reference's ``PartitionSpec`` s,
  entry by entry.
* The 4-rank train step (phi4-mini smoke, one AdamW step at lr = 1e-3):
  the loss within ``LOSS_RTOL`` = 2e-3 relative (``test_torch_train.py``).
  Step 0's gradients, gathered whole from the ranks, leaf by leaf within
  ``GRAD_TOL`` = 2 x ``BF16_TOL`` of the largest magnitude in the leaf;
  their global norm as the optimizer reckons it on the mesh within
  ``LOSS_RTOL`` relative (a sum over every element, as the loss is), and
  within 1e-5 of the norm of the gathered gradients (each shard counted
  once).  The parameters after the step by ``test_torch_train.py``'s
  banded rule: within one bf16 rounding (2^-7 x (|w| + 2 lr)) where the
  compared step-0 gradient lies outside the band of agreement (``GRAD_TOL``
  of the leaf's largest magnitude), and within 2 x lr plus one rounding
  inside it, where the two gradients can differ in sign (AdamW's first
  step moves every weight by about lr, whatever its gradient's size).
  Against the reference's jitted step and ``jax.grad`` on its own (2, 2)
  mesh, and against the port's ``rules=None`` step; on ``ideal``, and on
  ``reference`` (B1's plain version).
* ``moe_ep_a2a`` on a (1, 4) mesh: ``BF16_TOL`` = 4 x 2^-8 of the largest
  magnitude (``test_torch_models.py``); the dropped tokens (rows whose
  every routed expert overflowed: exact zeros) equal; the gradients of
  ``<y, cot>`` (a seeded f32 cotangent) for x and each expert leaf within
  ``GRAD_TOL`` of the leaf's largest magnitude; the refusal of a
  mismatched expert count word for word.  The router's gradient is held
  at top_k = 2 on a (2, 2) mesh, within ``GRAD_TOL`` likewise: at the
  config's top_k = 1 it is zero in exact arithmetic.
* A one-rank mesh shards nothing: its train and decode steps are bit-equal
  to the ``rules=None`` ones.
* The lowerings: the reference tests' collectives (``all-reduce`` +
  ``all-gather`` > 0 on a (4, 2) train step, ``all-to-all`` > 0 under
  ``ep_a2a``); a (2, 2, 2) pod mesh's per-rank argument bytes equal to the
  reference's ``memory_analysis().argument_size_in_bytes`` (every sharded
  dimension of starcoder2 smoke divides its mesh axes, so neither side
  pads).
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import mesh as jmesh
from repro.models import layers as jlayers
from repro.models import model_api as j_model_api
from repro.models import shardlib as jshard
from repro_torch import optim
from repro_torch.backend import use_backend
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import layers, model_api, params_from_numpy
from repro_torch.models import shardlib
from repro_torch.models.shardlib import (distribute_tree, tree_leaves,
                                         tree_map)
from repro_torch.roofline.comms import summarize_collectives
from repro_torch.train import make_train_step
from test_torch_models import BF16_TOL, _np_tree

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
LOSS_RTOL = 2e-3
GRAD_TOL = 2 * BF16_TOL
LR = 1e-3
TRAIN_ARCH = "phi4-mini-3.8b"
MOE_ARCH = "llama4-scout-17b-a16e"
BATCH, SEQ = 4, 32


def _env(devices=None):
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def _spawn(script, args, devices=None):
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script), *map(str, args)],
        env=_env(devices), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(procs, timeout=240):
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-4000:]


def _port_ranks(tmp, task, world):
    return [_spawn(_PORT_RANK, (rank, world, tmp, task))
            for rank in range(world)]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _rule_sets():
    """(name, the reference's rules, the port's) on meshes that exist only
    as axis names (``resolve`` needs no devices)."""
    two = ("data", "model")
    three = ("pod", "data", "model")
    out = [("replicated", jshard.replicated_rules(),
            shardlib.replicated_rules()),
           ("single_pod", jshard.single_pod_rules(),
            shardlib.single_pod_rules()),
           ("multi_pod", jshard.multi_pod_rules(),
            shardlib.multi_pod_rules())]
    for axes in (two, three):
        jm = types.SimpleNamespace(axis_names=axes)
        tm = types.SimpleNamespace(mesh_dim_names=axes)
        out += [(f"long_context{len(axes)}",
                 jmesh.rules_for_mesh(jm, long_context=True),
                 tmesh.rules_for_mesh(tm, long_context=True)),
                (f"tp2d{len(axes)}", jmesh.tp2d_rules(jm),
                 tmesh.tp2d_rules(tm)),
                (f"tp2d_long{len(axes)}",
                 jmesh.tp2d_rules(jm, long_context=True),
                 tmesh.tp2d_rules(tm, long_context=True))]
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_resolve_as_the_reference_for_every_arch(arch):
    """Parameter, MoE, decode-state and batch specs of every shipped arch,
    under every rule set, resolve to the reference's specs."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    japi, tapi = j_model_api(jcfg), model_api(tcfg, device="cpu")
    trees = [(japi.param_specs(), tapi.param_specs())]
    if tcfg.n_experts:
        other = "ffn" if tcfg.moe_shard == "expert" else "expert"
        trees.append((
            jlayers.moe_param_specs(dataclasses.replace(jcfg,
                                                        moe_shard=other)),
            layers.moe_param_specs(dataclasses.replace(tcfg,
                                                       moe_shard=other))))
    for name in J_SHAPES:
        js, ts = J_SHAPES[name], SHAPES[name]
        trees.append(({k: v.logical for k, v in japi.input_specs(js).items()},
                      {k: v.logical for k, v in tapi.input_specs(ts)
                       .items()}))
        if ts.kind == "decode":
            trees.append((japi.decode_state_specs(js),
                          tapi.decode_state_specs(ts)))
    checked = 0
    for _, jr, tr in _rule_sets():
        for jtree, ttree in trees:
            jflat, tflat = _flat(jtree), _flat(ttree)
            assert sorted(jflat) == sorted(tflat)
            for key, jleaf in jflat.items():
                jlog = jleaf if isinstance(jleaf, tuple) else jleaf.logical
                tleaf = tflat[key]
                tlog = tleaf if isinstance(tleaf, tuple) else tleaf.logical
                assert tuple(jlog) == tuple(tlog), key
                assert tr.resolve(tlog) == tuple(jr.resolve(jlog)), key
                checked += 1
    assert checked > 100
    specs = tapi.param_specs()
    assert (shardlib.spec_tree_to_pspecs(specs, shardlib.single_pod_rules())
            == tree_map(lambda s: shardlib.single_pod_rules().resolve(
                s.logical), specs))


def test_rules_placements_and_shard_rule():
    """Several mesh axes on one dimension become Shard(d) on each, in
    mesh-axis order; a dimension they do not divide stays replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(
        mesh_dim_names=("pod", "data", "model"),
        size=lambda i: (2, 16, 16)[i])
    rules = shardlib.multi_pod_rules(mesh)
    assert rules.placements(("fsdp", "tp")) == (Shard(0), Shard(0), Shard(1))
    assert rules.placements(("tp", "fsdp")) == (Shard(1), Shard(1), Shard(0))
    assert rules.placements(("batch", None, "tp"), (64, 8, 24)) == (
        Shard(0), Shard(0), Replicate())
    assert rules.placements(("seq_full",), (1024,)) == (Shard(0),) * 3
    assert shardlib.replicated_rules().sharding(("tp",)) is None
    assert shardlib.shard(torch.ones(2, 3), "batch", None).shape == (2, 3)


def test_production_meshes_and_their_refusals():
    with _fake((16, 16)) as mesh:
        assert tmesh.chips(mesh) == 256
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(tmesh.make_production_mesh().mesh.shape) == (16, 16)
        with pytest.raises(ValueError, match="512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
        assert tmesh.rules_for_mesh(mesh).table["batch"] == "data"
    with _fake((2, 16, 16), ("pod", "data", "model")) as mesh:
        assert tmesh.chips(mesh) == 512
        assert tmesh.rules_for_mesh(mesh).table["fsdp"] == ("pod", "data")
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_test_mesh((2, 2))
    with pytest.raises(ValueError, match="store_path"):
        tmesh.start_mesh((2, 2), ("data", "model"), backend="gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            tmesh.start_mesh((1, 1), ("data", "model"))
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW"):
        assert getattr(tmesh, name) > 0
    assert not hasattr(tmesh, "ICI_LINK_BW")


@contextlib.contextmanager
def _fake(shape, axes=("data", "model")):
    mesh = tmesh.start_mesh(shape, axes, backend="fake")
    try:
        yield mesh
    finally:
        tmesh.stop_mesh()


@contextlib.contextmanager
def _one_rank():
    mesh = tmesh.start_mesh((1, 1), ("data", "model"), backend="gloo")
    try:
        yield mesh
    finally:
        tmesh.stop_mesh()


def test_build_cell_picks_the_reference_rules():
    with _fake((2, 2)) as mesh:
        train = steps.build_cell(TRAIN_ARCH, ShapeConfig("t", 32, 4,
                                                         "train"),
                                 mesh, smoke=True)
        assert train.kind == "train"
        assert train.rules.table == tmesh.rules_for_mesh(mesh).table
        long = steps.build_cell("zamba2-2.7b", SHAPES["long_500k"], mesh,
                                smoke=True)
        assert long.kind == "decode" and long.rules.table["batch"] is None
        tp2d = steps.build_cell(
            TRAIN_ARCH, SHAPES["decode_32k"], mesh, smoke=True,
            overrides={"serve_weight_layout": "tp2d"})
        assert tp2d.rules.table["tp"] == ("data", "model")
        assert tp2d.rules.table["fsdp"] is None
        prefill = steps.build_cell("rwkv6-1.6b", SHAPES["prefill_32k"], mesh,
                                   smoke=True)
        assert prefill.kind == "prefill" and len(prefill.arg_specs) == 2


# ---------------------------------------------------------------------------
# the port's ranks and the reference's mesh, in processes of their own
# ---------------------------------------------------------------------------

_GRADS0 = """
    def grads0(api, params, batch, rules):
        \"\"\"Step 0's gradients, each gathered whole, and their global norm
        as ``apply_updates`` reckons it: on the parameters' layout, each
        rank's shards summed, then the ranks.\"\"\"
        import torch
        from repro_torch import optim
        from repro_torch.models.shardlib import (is_dtensor, tree_leaves,
                                                 tree_map, use_rules)
        from repro_torch.train.trainer import distribute_batch
        leaves = tree_leaves(params)
        with use_rules(rules), torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = api.train_loss(params, distribute_batch(batch, rules))
            grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        laid = [g.redistribute(p.device_mesh, p.placements)
                if is_dtensor(g) else g for g, p in zip(grads, leaves)]
        it = iter(laid)
        with use_rules(rules):
            norm = optim.global_norm(tree_map(lambda _: next(it), params))
        it = iter([g.full_tensor() if is_dtensor(g) else g for g in laid])
        return tree_map(lambda _: next(it), params), float(norm)
"""

_NS = {}
exec(textwrap.dedent(_GRADS0), _NS)
_grads0 = _NS["grads0"]

_PORT_RANK = textwrap.dedent(_GRADS0) + textwrap.dedent("""
    import dataclasses, sys
    import torch
    rank, world, tmp, task = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    from repro_torch import optim
    from repro_torch.backend import get_backend, use_backend
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import rules_for_mesh, start_mesh, stop_mesh
    from repro_torch.models import layers, model_api
    from repro_torch.models.shardlib import (distribute_tree, tree_map,
                                             use_rules)
    from repro_torch.train import make_train_step
    inputs = torch.load(f"{tmp}/inputs.pt", weights_only=True)
    if task == "train":
        mesh = start_mesh((2, 2), ("data", "model"), backend="gloo",
                          rank=rank, store_path=f"{tmp}/store")
        rules = rules_for_mesh(mesh)
        cfg = get_config("phi4-mini-3.8b", smoke=True)
        api = model_api(cfg, device="cpu")
        ocfg = optim.AdamWConfig(lr=inputs["lr"], warmup_steps=1,
                                 total_steps=5)
        out = {}
        for backend in ("ideal", "reference"):
            params = tree_map(lambda t: t.clone(), inputs["params"])
            state = optim.init_state(params, ocfg)
            params = distribute_tree(params, api.param_specs(), rules)
            state = distribute_tree(
                state, optim.state_specs(api.param_specs(), ocfg), rules)
            with use_backend(get_backend(backend, device="cpu")):
                grads, gnorm = grads0(api, params, inputs["batch"], rules)
            be = get_backend(backend, device="cpu")
            with use_backend(be):
                _, state, loss = make_train_step(api, cfg, ocfg, rules)(
                    params, state, inputs["batch"])
            out[backend] = {
                "loss": float(loss),
                "params": tree_map(lambda t: t.full_tensor(), params),
                "grads": grads, "gnorm": gnorm,
                "calls": be.summary()["calls"]}
    else:
        shape = tuple(inputs["mesh"])
        mesh = start_mesh(shape, ("data", "model"), backend="gloo",
                          rank=rank, store_path=f"{tmp}/store")
        rules = rules_for_mesh(mesh)
        cfg = dataclasses.replace(
            get_config("llama4-scout-17b-a16e", smoke=True),
            moe_impl="ep_a2a", n_experts=shape[1], moe_shard="expert",
            capacity_factor=inputs["capacity_factor"], top_k=inputs["top_k"])
        specs = layers.moe_param_specs(cfg, layers=0)
        p = distribute_tree(inputs["params"], specs, rules)
        x = distribute_tree(inputs["x"], layers.ParamSpec(
            tuple(inputs["x"].shape), torch.bfloat16,
            ("batch", None, None)), rules)
        leaves = [x] + [p[k] for k in sorted(p)]
        for t in leaves:
            t.requires_grad_(True)
        with use_rules(rules):
            y = layers.moe(x, p, cfg)
            # the gradients of <y, cot> for x and every expert leaf
            grads = torch.autograd.grad(
                (y.to(torch.float32) * inputs["cot"]).sum(), leaves,
                allow_unused=True)
            try:
                with torch.no_grad():
                    layers.moe(x, p, dataclasses.replace(cfg, n_experts=8))
                refusal = None
            except ValueError as err:
                refusal = str(err)
        out = {"y": y.detach().full_tensor(),
               "placements": str(y.placements), "refusal": refusal,
               "grads": dict(zip(["x"] + sorted(p), [
                   None if g is None else g.full_tensor() for g in grads]))}
    if rank == 0:
        torch.save(out, f"{tmp}/port.pt")
    stop_mesh()
""")

_PORT_SERVE = """
    import sys
    import torch
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import start_mesh, stop_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model_api
    from repro_torch.backend import get_backend, use_backend
    from repro_torch.models.shardlib import distribute_tree
    inputs = torch.load(f"{tmp}/serve_inputs.pt", weights_only=True)
    mesh = start_mesh((2, 2), ("data", "model"), backend="gloo", rank=rank,
                      store_path=f"{tmp}/store")
    out = {}
    scope = use_backend(get_backend("reference", device="cpu"))
    scope.__enter__()
    for arch, run in inputs.items():
        cfg = get_config(arch, smoke=True)
        api = model_api(cfg, device="cpu")
        dshape = ShapeConfig("d", run["max_len"], 2, "decode")
        cell = build_cell(arch, dshape, mesh, smoke=True)
        params = distribute_tree(run["params"], api.param_specs(),
                                 cell.rules)
        logits = []
        if "prompt" in run:
            pcell = build_cell(arch, ShapeConfig("p", run["max_len"], 2,
                                                 "prefill"), mesh, smoke=True)
            first, state = pcell.fn(params, run["prompt"])
            logits.append(first.full_tensor())
        else:
            state = distribute_tree(api.make_decode_state(dshape),
                                    api.decode_state_specs(dshape),
                                    cell.rules)
        for tok in run["feed"]:
            got, state = cell.fn(params, state, tok)
            logits.append(got.full_tensor())
        out[arch] = logits
    if rank == 0:
        torch.save(out, f"{tmp}/port_serve.pt")
    stop_mesh()
"""

_JAX_TRAIN = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import optim
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_test_mesh, rules_for_mesh
    from repro.launch.steps import build_train_step
    from repro.models import model_api
    from repro.models.shardlib import spec_tree_to_shardings, use_rules
    tmp, lr, arch = sys.argv[1], float(sys.argv[2]), sys.argv[3]
    mesh = make_test_mesh((2, 2), ("data", "model"))
    cfg = get_config(arch, smoke=True)
    batch = dict(np.load(f"{tmp}/batch.npz"))
    b, s = batch["tokens"].shape
    ocfg = optim.AdamWConfig(lr=lr, warmup_steps=1, total_steps=5)
    shape = ShapeConfig("t", s, b, "train")
    rules = rules_for_mesh(mesh)
    step = build_train_step(cfg, shape, rules, ocfg)
    api = model_api(cfg)
    params = api.init_params(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def grads0(p, b):
        with use_rules(rules):
            return jax.grad(api.loss)(p, b)

    with use_rules(rules):
        grads = jax.jit(grads0, in_shardings=(
            spec_tree_to_shardings(api.param_specs(), rules),
            {k: rules.sharding(v.logical)
             for k, v in api.input_specs(shape).items()}))(params, batch)
    gnorm = optim.global_norm(grads)
    state = optim.init_state(params, ocfg)
    params, state, loss = step.fn(params, state, batch)

    def flat(tree, prefix):
        return {prefix + "/".join(str(k.key) for k in path): np.asarray(
            leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    np.savez(f"{tmp}/jax.npz", loss=np.asarray(loss),
             gnorm=np.asarray(gnorm), **flat(params, "param:"),
             **flat(grads, "grad:"))
"""

_JAX_MOE = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh, rules_for_mesh
    from repro.models import layers, model_api
    from repro.models.shardlib import use_rules
    tmp, cf, top_k = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
    shape = (int(sys.argv[4]), int(sys.argv[5]))
    mesh = make_test_mesh(shape, ("data", "model"))
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e", smoke=True),
                              moe_impl="ep_a2a", n_experts=shape[1],
                              moe_shard="expert", capacity_factor=cf,
                              top_k=top_k)
    params = model_api(cfg).init_params(jax.random.PRNGKey(0))
    p0 = jax.tree.map(lambda t: t[0], params["blocks"]["moe"])
    x = jnp.asarray(np.load(f"{tmp}/x.npy")).astype(jnp.bfloat16)
    cot = jnp.asarray(np.load(f"{tmp}/cot.npy"))
    with use_rules(rules_for_mesh(mesh)):
        y = jax.jit(lambda x, p: layers.moe(x, p, cfg))(x, p0)
        gx, gp = jax.jit(jax.grad(lambda x, p: jnp.sum(
            layers.moe(x, p, cfg).astype(jnp.float32) * cot),
            argnums=(0, 1)))(x, p0)
        try:
            layers.moe(x, p0, dataclasses.replace(cfg, n_experts=8))
            refusal = None
        except ValueError as err:
            refusal = str(err)
    np.save(f"{tmp}/jax_y.npy", np.asarray(y.astype(jnp.float32)))
    np.savez(f"{tmp}/jax_grads.npz", x=np.asarray(gx.astype(jnp.float32)),
             **{k: np.asarray(v.astype(jnp.float32)) for k, v in gp.items()})
    json.dump({"refusal": refusal}, open(f"{tmp}/jax.json", "w"))
"""


def _train_batch(cfg):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def mesh_train(tmp_path_factory):
    """One AdamW step of phi4-mini smoke from the reference's weights: the
    reference's jitted step on its (2, 2) mesh, the port's on a 4-rank
    gloo (2, 2) mesh (``ideal`` and ``reference``), and the port's
    ``rules=None`` steps."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    cfg = get_config(TRAIN_ARCH, smoke=True)
    jparams = j_model_api(j_get_config(TRAIN_ARCH, smoke=True)).init_params(
        jax.random.PRNGKey(0))
    api = model_api(cfg, device="cpu")
    params = params_from_numpy(_np_tree(jparams), api.param_specs(), "cpu")
    batch = _train_batch(cfg)
    np.savez(tmp / "batch.npz", **batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"params": params, "batch": tbatch, "lr": LR},
               tmp / "inputs.pt")
    procs = [_spawn(_JAX_TRAIN, (tmp, LR, TRAIN_ARCH), devices=4)]
    procs += _port_ranks(tmp, "train", 4)
    ocfg = optim.AdamWConfig(lr=LR, warmup_steps=1, total_steps=5)
    alone = {}
    for backend in ("ideal", "reference"):
        p = tree_map(lambda t: t.clone(), params)
        with use_backend(backend, device="cpu"):
            grads, gnorm = _grads0(api, p, tbatch, None)
        with use_backend(backend, device="cpu"):
            _, _, loss = make_train_step(api, cfg, ocfg)(
                p, optim.init_state(p, ocfg), tbatch)
        alone[backend] = {"loss": float(loss), "params": p, "grads": grads,
                          "gnorm": gnorm}
    _finish(procs)
    jout = np.load(tmp / "jax.npz")
    ref = {"loss": float(jout["loss"]), "gnorm": float(jout["gnorm"])}
    for part in ("param", "grad"):
        ref[part + "s"] = {k.split(":", 1)[1]: jout[k] for k in jout.files
                           if k.startswith(part + ":")}
    return ref, torch.load(tmp / "port.pt", weights_only=True), alone


def _np64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def _assert_step0_agrees(got, want):
    """``got``'s step-0 gradients, their norm and the parameters after the
    step against ``want``'s (flat trees), by the tolerances stated at the
    top: ``test_torch_train.py``'s gradient and banded parameter rules."""
    grads, params = _flat(got["grads"]), _flat(got["params"])
    assert sorted(grads) == sorted(want["grads"]) == sorted(params)
    own = 0.0
    for key, wg in want["grads"].items():
        g, wg = _np64(grads[key]), _np64(wg)
        assert g.shape == wg.shape, key
        assert np.abs(g - wg).max() <= GRAD_TOL * np.abs(wg).max(), key
        own += float(np.sum(np.square(g)))
        p, w = _np64(params[key]), _np64(want["params"][key])
        diff = np.abs(p - w)
        rounding = 2.0 ** -7 * (np.abs(w) + 2 * LR)
        band = np.abs(wg) <= GRAD_TOL * np.abs(wg).max()
        assert (diff[~band] <= rounding[~band]).all(), key
        assert (diff <= 2 * LR + rounding).all(), key
    # the mesh's norm counts each shard once
    assert abs(got["gnorm"] - own ** 0.5) <= 1e-5 * own ** 0.5
    assert abs(got["gnorm"] - want["gnorm"]) <= LOSS_RTOL * want["gnorm"]


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_train_step_on_a_4_rank_mesh_matches_the_reference_mesh(
        mesh_train, backend):
    ref, port, _ = mesh_train
    got = port[backend]
    assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    _assert_step0_agrees(got, ref)


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_train_step_on_a_4_rank_mesh_matches_rules_none(mesh_train, backend):
    _, port, alone = mesh_train
    got, want = port[backend], alone[backend]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    _assert_step0_agrees(got, {**want, "grads": _flat(want["grads"]),
                               "params": _flat(want["params"])})
    if backend == "reference":
        # every rank routes every GEMM of the step through the backend once
        # (its local block): 13 L + 1, as unsharded
        assert got["calls"] == 13 * get_config(TRAIN_ARCH,
                                               smoke=True).n_layers + 1


def _moe_ep_a2a_case(tmp, top_k, mesh=(1, 4)):
    """llama4-scout smoke's expert layer with an expert on each rank of
    ``mesh``'s model axis and ``top_k`` routed, at capacity factor 0.5
    (tokens drop): the reference's on its ``mesh``, the port's on a gloo
    ``mesh``, and the port's dense dispatch of the same tokens.  Returns
    (x, the port's run, the reference's y and gradients, the reference's
    refusal, the dense y)."""
    cf = 0.5
    cfgs = [dataclasses.replace(
        get(MOE_ARCH, smoke=True), moe_impl="ep_a2a", n_experts=mesh[1],
        moe_shard="expert", capacity_factor=cf, top_k=top_k)
        for get in (j_get_config, get_config)]
    jparams = j_model_api(cfgs[0]).init_params(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        _np_tree(jparams), model_api(cfgs[1], device="cpu").param_specs(),
        "cpu")
    p0 = tree_map(lambda t: t[0].clone(), tparams["blocks"]["moe"])
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfgs[1].d_model)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    cot = np.random.default_rng(6).standard_normal(x.shape).astype(
        np.float32)
    np.save(tmp / "x.npy", x)
    np.save(tmp / "cot.npy", cot)
    torch.save({"params": p0, "x": torch.from_numpy(x).to(torch.bfloat16),
                "cot": torch.from_numpy(cot), "capacity_factor": cf,
                "top_k": top_k, "mesh": mesh}, tmp / "inputs.pt")
    procs = [_spawn(_JAX_MOE, (tmp, cf, top_k, *mesh), devices=4)]
    procs += _port_ranks(tmp, "moe", 4)
    with torch.no_grad():
        dense = layers.moe_dense(torch.from_numpy(x).to(torch.bfloat16), p0,
                                 cfgs[1])
    _finish(procs)
    return (x, torch.load(tmp / "port.pt", weights_only=True),
            np.load(tmp / "jax_y.npy"), np.load(tmp / "jax_grads.npz"),
            json.loads((tmp / "jax.json").read_text())["refusal"],
            dense.to(torch.float32).numpy())


def _assert_moe_grads_agree(got, jgrads, skip=()):
    """The gradients of ``<y, cot>``: the exchange's (x), the experts'
    (``w_grad``) and the router's (``r_grad``) sums over the token
    splits."""
    assert sorted(jgrads.files) == sorted(got["grads"])
    compared = 0
    for key, g in got["grads"].items():
        w = jgrads[key]
        if g is None:             # a leaf moe() does not read
            assert not w.any(), key
            continue
        g = g.to(torch.float32).numpy()
        assert g.shape == w.shape and np.abs(w).max() > 0, key
        if key in skip:
            continue
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), key
        compared += 1
    assert compared >= 4 - len(skip)


def test_moe_ep_a2a_on_a_4_rank_mesh_matches_the_reference(tmp_path):
    x, got, want, jgrads, jmsg, d = _moe_ep_a2a_case(tmp_path, top_k=1)
    y = got["y"].to(torch.float32).numpy()
    assert y.shape == want.shape == (2, 16, x.shape[-1])
    assert np.abs(y - want).max() <= BF16_TOL * np.abs(want).max()
    dropped = np.all(want == 0, axis=-1)
    assert 0 < dropped.sum() < dropped.size
    np.testing.assert_array_equal(np.all(y == 0, axis=-1), dropped)
    # the kept tokens are what the dense dispatch computes for them
    kept = ~dropped
    assert np.abs(y[kept] - d[kept]).max() <= BF16_TOL * np.abs(d).max()
    # with one expert a token the renormalised gate is p / p = 1 whatever
    # the logits: the router's gradient is zero in exact arithmetic and
    # both stacks give rounding noise there, so top_k = 2 holds it
    # (test_moe_ep_a2a_gradients_with_two_experts_a_token_match_the_reference)
    _assert_moe_grads_agree(got, jgrads, skip=("router",))
    assert jmsg and got["refusal"] == jmsg
    assert "Shard(dim=0)" in got["placements"]


def test_moe_ep_a2a_gradients_with_two_experts_a_token_match_the_reference(
        tmp_path):
    """At top_k = 2 the gate weights depend on the router's logits: every
    gradient, the router's included, against the reference's mesh.  On a
    (2, 2) mesh (two experts), so that the experts' gradients also sum
    over the batch split."""
    x, got, want, jgrads, _, _ = _moe_ep_a2a_case(tmp_path, top_k=2,
                                                   mesh=(2, 2))
    y = got["y"].to(torch.float32).numpy()
    assert np.abs(y - want).max() <= BF16_TOL * np.abs(want).max()
    _assert_moe_grads_agree(got, jgrads)


SERVE_ARCHS = ("phi4-mini-3.8b", "rwkv6-1.6b", "seamless-m4t-medium")


def test_serving_on_a_4_rank_mesh_matches_no_mesh(tmp_path):
    """Prefill and decode steps on a gloo (2, 2) mesh on ``reference``: the
    KV caches split over the sequence (``seq_tp``, two halves of 8 slots:
    the steps cross the boundary), rwkv6's recurrence on (batch, head)
    blocks, seamless's cache and memory filled shard by shard.  Each GEMM
    sums over a whole K on every rank and each attention head runs whole,
    and a GEMM row's bits do not depend on the rows beside it (the CPU's
    route sums in float64, ROADMAP C13), so every step's logits are
    bit-equal to the unsharded step's (the same tokens fed to both).  The
    other families: ``test_torch_mesh_serve_families.py``.  On ``ideal``
    DTensor may split K and add bf16 partial sums: 1.75 % of max|logits|
    on rwkv6 smoke (ROADMAP C12)."""
    rng = np.random.default_rng(7)
    inputs, want = {}, {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch, smoke=True)
        api = model_api(cfg, device="cpu")
        params = api.init_params(0)
        feed = [torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 1))
                                 .astype(np.int32)) for _ in range(6)]
        run = {"params": params, "feed": feed, "max_len": 16}
        logits = []
        scope = use_backend("reference", device="cpu")
        scope.__enter__()
        if cfg.family != "ssm":
            prompt = {"tokens": torch.from_numpy(rng.integers(
                3, cfg.vocab_size, (2, 5)).astype(np.int32))}
            if cfg.family == "encdec":
                prompt["frames"] = torch.from_numpy(rng.standard_normal(
                    (2, 16 // cfg.enc_frames_ratio, cfg.d_model)).astype(
                        np.float32)).to(torch.bfloat16)
            run["prompt"] = prompt
            first, state = api.prefill(params, prompt, max_len=16)
            logits.append(first)
        else:
            state = api.make_decode_state(ShapeConfig("d", 16, 2, "decode"))
        for tok in feed:
            got, state = api.decode_step(params, state, tok)
            logits.append(got.clone())
        scope.__exit__(None, None, None)
        inputs[arch], want[arch] = run, logits
    torch.save(inputs, tmp_path / "serve_inputs.pt")
    _finish([_spawn(_PORT_SERVE, (rank, 4, tmp_path))
             for rank in range(4)])
    got = torch.load(tmp_path / "port_serve.pt", weights_only=True)
    for arch in SERVE_ARCHS:
        assert len(got[arch]) == len(want[arch])
        for g, w in zip(got[arch], want[arch]):
            assert torch.equal(g, w), arch


# ---------------------------------------------------------------------------
# one rank: bit-equal to no mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ideal", "reference"])
def test_one_rank_mesh_train_step_is_bit_equal_to_rules_none(backend):
    cfg = get_config(TRAIN_ARCH, smoke=True)
    api = model_api(cfg, device="cpu")
    ocfg = optim.AdamWConfig(lr=LR, warmup_steps=1)
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg).items()}
    with _one_rank() as mesh:
        cell = steps.build_cell(TRAIN_ARCH, ShapeConfig("t", SEQ, BATCH,
                                                        "train"),
                                mesh, smoke=True, opt_cfg=ocfg)
        runs = []
        for rules in (None, cell.rules):
            p = api.init_params(0)
            s = optim.init_state(p, ocfg)
            if rules is not None:
                p = distribute_tree(p, api.param_specs(), rules)
                s = distribute_tree(s, optim.state_specs(api.param_specs(),
                                                         ocfg), rules)
            fn = cell.fn if rules is not None else make_train_step(
                api, cfg, ocfg)
            with use_backend(backend, device="cpu") as be:
                _, s, loss = fn(p, s, batch)
            runs.append((loss, p, s, be.summary()["calls"]))
        (l0, p0, s0, c0), (l1, p1, s1, c1) = runs
        assert torch.equal(l0, l1) and c0 == c1
        for a, b in zip(tree_leaves(p0) + tree_leaves(s0),
                        tree_leaves(p1) + tree_leaves(s1)):
            assert torch.equal(a, b.to_local())


def test_train_on_a_one_rank_mesh_equals_rules_none_and_resumes(tmp_path):
    """``train(rules=...)`` distributes the seeded parameters and state,
    checkpoints gathered leaves and resumes into the mesh's shards: its
    losses are the ``rules=None`` run's, bit for bit."""
    from repro_torch.train import TrainConfig, train
    cfg = get_config(TRAIN_ARCH, smoke=True)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    ocfg = optim.AdamWConfig(lr=LR, warmup_steps=1, total_steps=4)
    plain = train(cfg, shape, TrainConfig(steps=4, log_every=0,
                                          checkpoint_every=0), ocfg,
                  device="cpu")
    with _one_rank() as mesh:
        rules = tmesh.rules_for_mesh(mesh)
        first = train(cfg, shape, TrainConfig(
            steps=2, log_every=0, checkpoint_every=2,
            checkpoint_dir=str(tmp_path), async_checkpoint=False), ocfg,
            rules=rules, device="cpu")
        rest = train(cfg, shape, TrainConfig(
            steps=4, log_every=0, checkpoint_every=0,
            checkpoint_dir=str(tmp_path)), ocfg, rules=rules,
            device="cpu", resume=True)
    assert first.losses + rest.losses == plain.losses
    assert rest.steps_done == 2
    leaf = tree_leaves(rest.final_params)[0]
    assert type(leaf).__name__ == "DTensor"
    assert all(torch.equal(a.detach(), b.to_local()) for a, b in zip(
        tree_leaves(plain.final_params), tree_leaves(rest.final_params)))


def test_one_rank_mesh_decode_is_bit_equal_and_checkpoints_gather(tmp_path):
    cfg = get_config(TRAIN_ARCH, smoke=True)
    api = model_api(cfg, device="cpu")
    shape = ShapeConfig("d", 16, 2, "decode")
    params = api.init_params(0)
    with _one_rank() as mesh:
        cell = steps.build_cell(TRAIN_ARCH, shape, mesh, smoke=True)
        dparams = distribute_tree(params, api.param_specs(), cell.rules)
        dstate = distribute_tree(api.make_decode_state(shape),
                                 api.decode_state_specs(shape), cell.rules)
        state = api.make_decode_state(shape)
        tok = torch.tensor([[3], [5]], dtype=torch.int32)
        with use_backend("reference", device="cpu"):
            for _ in range(4):
                want, state = api.decode_step(params, state, tok)
                got, dstate = cell.fn(dparams, dstate, tok)
                assert torch.equal(want, got.full_tensor())
                tok = want.argmax(-1, keepdim=True).to(torch.int32)
        assert torch.equal(state["kv"]["k"], dstate["kv"]["k"].to_local())
        # prefill on the mesh: the cache filled shard by shard
        pshape = ShapeConfig("p", 16, 2, "prefill")
        pcell = steps.build_cell(TRAIN_ARCH, pshape, mesh, smoke=True)
        prompt = {"tokens": torch.tensor([[3, 9, 4, 7], [5, 1, 8, 2]],
                                         dtype=torch.int32)}
        with use_backend("reference", device="cpu"):
            want, wstate = api.prefill(params, prompt, max_len=16)
            got, gstate = pcell.fn(dparams, prompt)
        assert torch.equal(want, got.full_tensor())
        assert torch.equal(wstate["kv"]["v"], gstate["kv"]["v"].full_tensor())
        # a mesh's checkpoint holds whole leaves and restores into shards
        ckpt = CheckpointManager(tmp_path)
        ckpt.save(1, dparams)
        blank = distribute_tree(tree_map(torch.zeros_like, params),
                                api.param_specs(), cell.rules)
        ckpt.restore(blank)
        for a, b in zip(tree_leaves(params), tree_leaves(blank)):
            assert torch.equal(a, b.to_local())
        back = CheckpointManager(tmp_path).restore(
            tree_map(torch.zeros_like, params))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                     tree_leaves(back)))


# ---------------------------------------------------------------------------
# lowering on fake process groups (tests/distributed/test_distributed.py)
# ---------------------------------------------------------------------------


def _kinds(lowered):
    return {k: v["count"]
            for k, v in summarize_collectives(lowered.collectives).items()}


def test_smoke_train_step_lowering_on_4x2_mesh():
    with _fake((4, 2)) as mesh:
        step = steps.build_train_step(
            get_config(TRAIN_ARCH, smoke=True), ShapeConfig("t", 64, 8,
                                                            "train"),
            tmesh.rules_for_mesh(mesh))
        lowered = step.lower()
    kinds = _kinds(lowered)
    assert kinds.get("all-reduce", 0) + kinds.get("all-gather", 0) > 0
    assert lowered.memory["argument_bytes"] > 0
    assert lowered.cost["flops"] > 0 and lowered.cost["bytes accessed"] > 0
    assert lowered.trace_s > 0 and lowered.kind == "train"
    # the step writes its parameters and state in place
    assert lowered.memory["alias_bytes"] == lowered.memory["output_bytes"] - 4


def test_smoke_decode_step_lowering_seq_sharded_cache():
    from torch.distributed.tensor import Shard
    cfg = get_config("qwen1.5-110b", smoke=True)
    shape = ShapeConfig("t", 64, 4, "decode")
    with _fake((2, 4)) as mesh:
        rules = tmesh.rules_for_mesh(mesh)
        step = steps.build_decode_step(cfg, shape, rules)
        kv = model_api(cfg, device="cpu").decode_state_specs(shape)["kv"]
        assert rules.placements(kv["k"].logical, kv["k"].shape)[1] == \
            Shard(2)
        lowered = step.lower()
    assert lowered.kind == "decode" and lowered.cost["flops"] > 0
    assert sum(_kinds(lowered).values()) > 0


def test_smoke_prefill_lowering_fills_a_sharded_cache():
    cfg = get_config(TRAIN_ARCH, smoke=True)
    with _fake((2, 4)) as mesh:
        lowered = steps.build_prefill_step(
            cfg, ShapeConfig("p", 64, 4, "prefill"),
            tmesh.rules_for_mesh(mesh)).lower()
    assert lowered.kind == "prefill" and lowered.cost["flops"] > 0
    # the cache it returns: each rank's (L, b/2, S/4, kv, d) shards
    kv = model_api(cfg, device="cpu").decode_state_specs(
        ShapeConfig("p", 64, 4, "decode"))["kv"]
    per_rank = sum(int(np.prod(s.shape)) // 8 * 2 for s in kv.values())
    assert lowered.memory["output_bytes"] >= per_rank


def test_moe_ep_a2a_produces_all_to_all():
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e", smoke=True),
                              moe_impl="ep_a2a", n_experts=4,
                              moe_shard="expert")
    with _fake((2, 4)) as mesh:
        lowered = steps.build_train_step(
            cfg, ShapeConfig("t", 64, 4, "train"),
            tmesh.rules_for_mesh(mesh)).lower()
    assert _kinds(lowered).get("all-to-all", 0) > 0


_JAX_POD_ARGS = """
    import json
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_test_mesh, rules_for_mesh
    from repro.launch.steps import build_train_step
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    step = build_train_step(get_config("starcoder2-3b", smoke=True),
                            ShapeConfig("t", 64, 8, "train"),
                            rules_for_mesh(mesh))
    ma = step.lower().compile().memory_analysis()
    print(json.dumps({"args": ma.argument_size_in_bytes}))
"""


def test_multi_pod_mesh_shards_pod_axis():
    ref = _spawn(_JAX_POD_ARGS, (), devices=8)
    cfg = get_config("starcoder2-3b", smoke=True)
    with _fake((2, 2, 2), ("pod", "data", "model")) as mesh:
        rules = tmesh.rules_for_mesh(mesh)
        step = steps.build_train_step(cfg, ShapeConfig("t", 64, 8, "train"),
                                      rules)
        # every sharded dimension divides: no shard is padded on either side
        for spec in tree_leaves(step.arg_specs[0]):
            assert rules.placements(spec.logical, spec.shape) == \
                rules.placements(spec.logical)
        lowered = step.lower()
    out, err = ref.communicate(timeout=240)
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])["args"]
    assert lowered.memory["argument_bytes"] == want > 0


def test_one_device_lowering_has_no_collectives():
    cfg = get_config(TRAIN_ARCH, smoke=True)
    step = steps.build_train_step(cfg, ShapeConfig("t", 32, 4, "train"),
                                  device="cpu")
    lowered = step.lower()
    assert lowered.collectives == [] and lowered.cost["flops"] > 0
    params = model_api(cfg, device="cpu").param_specs()
    n = sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
            .element_size() for s in tree_leaves(params))
    assert lowered.memory["argument_bytes"] > n


def test_mesh_trace_splits_the_batch():
    """Gradients keep the batch split: the backward of a sum hands back a
    replicated gradient, and ``shard`` constrains it to its own layout
    (ROADMAP C12); without that every activation gradient, and the
    weight-gradient GEMMs, ran at the global batch on each rank (phi4-mini x
    train_4k x pod_16x16: 7.09e14 flops a rank, against 5.73e14).  The
    (4, 2) train step's per-rank flops are at most half one device's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    cfg = get_config(TRAIN_ARCH, smoke=True)
    shape = ShapeConfig("t", 64, 8, "train")
    one = steps.build_train_step(cfg, shape, device="cpu").lower()
    with _fake((4, 2)) as mesh:
        rules = tmesh.rules_for_mesh(mesh)
        x = DTensor.from_local(torch.ones(2, 3), mesh,
                               [Shard(0), Replicate()], run_check=False)
        x.requires_grad_(True)
        with shardlib.use_rules(rules):
            y = shardlib.shard(x * 2.0, "batch", None)
        (g,) = torch.autograd.grad(y.sum(), [x])
        assert tuple(g.placements) == (Shard(0), Replicate())
        lowered = steps.build_train_step(cfg, shape, rules).lower()
    assert lowered.cost["flops"] <= one.cost["flops"] / 2
    assert lowered.memory["temp_bytes"] < one.memory["temp_bytes"]
