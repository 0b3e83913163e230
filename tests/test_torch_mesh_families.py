"""Every model family of the port on a device mesh, on the CPU.

* Each shipped arch's train, prefill and decode steps (smoke config) lower
  on a ``fake`` (2, 2) mesh with every collective a rank would issue, as
  ``launch.dryrun`` lowers them; rwkv6's and zamba2's train cells take
  their recurrences' gradients on (batch, head) blocks, rwkv6's also with
  ``ssm_bf16=True`` (the bf16 backward).
* On a 4-rank ``gloo`` (2, 2) mesh (one process a rank), rwkv6's and
  zamba2's step-0 gradients on ``reference`` equal the unsharded ones
  within the train tests' ``GRAD_TOL``: the recurrences run on (batch,
  head) blocks, and the gradients of the operands a rank holds whole over a
  split (u; A_log, D, B, C) are that rank's part of a sum.
* On a one-rank ``gloo`` mesh, which shards nothing, the steps of the paths
  that take each family's own mesh code are bit-equal to the unsharded
  ones: rwkv6's recurrence on (batch, head) blocks, zamba2's, seamless's
  prefill (its cache and memory filled shard by shard), grok's, llava's,
  rwkv6's, zamba2's and seamless's train steps (the MoE router row by row,
  the patch prefix, the recurrences' backward passes on their blocks, the
  encoder's frames).
"""

import contextlib
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.backend import use_backend
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import model_api
from repro_torch.models.shardlib import distribute_tree, tree_leaves
from repro_torch.train import make_train_step
from test_torch_mesh import _GRADS0, _finish, _spawn
from test_torch_train import GRAD_TOL

KINDS = ("train", "prefill", "decode")


@contextlib.contextmanager
def _mesh(shape, backend):
    mesh = tmesh.start_mesh(shape, ("data", "model"), backend=backend)
    try:
        yield mesh
    finally:
        tmesh.stop_mesh()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_family_lowers_on_a_2x2_mesh(arch, kind):
    shape = ShapeConfig(kind, 64, 4, kind)
    with _mesh((2, 2), "fake") as mesh:
        lowered = steps.build_cell(arch, shape, mesh, smoke=True).lower()
    assert lowered.cost["flops"] > 0
    assert lowered.memory["argument_bytes"] > 0
    assert sum(1 for _ in lowered.collectives) > 0


def test_rwkv6_with_ssm_bf16_lowers_its_train_step_on_a_2x2_mesh(
        monkeypatch):
    """The bf16 recurrence's train cell (``ssm_bf16=True``, the config's
    override) lowers as the shipped configs' do: each rank's (batch, head)
    block through ``local_map`` takes the bf16 backward, and its bf16
    gradients of r, k and v pass its ``in_grad_placements``."""
    from repro_torch.kernels import wkv6 as wmod
    seen = []
    real = wmod.wkv6_backward_plain

    def spy(*args, **kw):
        seen.append(kw["compute_dtype"])
        return real(*args, **kw)
    monkeypatch.setattr(wmod, "wkv6_backward_plain", spy)
    shape = ShapeConfig("train", 64, 4, "train")
    with _mesh((2, 2), "fake") as mesh:
        cell = steps.build_cell("rwkv6-1.6b", shape, mesh, smoke=True,
                                overrides={"ssm_bf16": True})
        lowered = cell.lower()
    assert cell.api.cfg.ssm_bf16
    assert seen and set(seen) == {torch.bfloat16}
    assert lowered.cost["flops"] > 0
    assert lowered.memory["argument_bytes"] > 0
    assert sum(1 for _ in lowered.collectives) > 0


def _batch(cfg, b, s, seed=3):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(3, cfg.vocab_size, (b, s + 1), generator=gen,
                         dtype=torch.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        out["patch_embeds"] = torch.randn(
            (b, min(cfg.frontend_tokens, s // 2), cfg.d_model),
            generator=gen).to(torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = torch.randn(
            (b, max(s // cfg.enc_frames_ratio, 1), cfg.d_model),
            generator=gen).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("arch", ["grok-1-314b", "llava-next-mistral-7b",
                                  "rwkv6-1.6b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_one_rank_mesh_train_step_of_the_other_families(arch):
    cfg = get_config(arch, smoke=True)
    api = model_api(cfg, device="cpu")
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    batch = _batch(cfg, 4, 32)
    with _mesh((1, 1), "gloo") as mesh:
        cell = steps.build_cell(arch, ShapeConfig("t", 32, 4, "train"), mesh,
                                smoke=True, opt_cfg=ocfg)
        out = []
        for rules in (None, cell.rules):
            p = api.init_params(0)
            s = optim.init_state(p, ocfg)
            if rules is not None:
                p = distribute_tree(p, api.param_specs(), rules)
                s = distribute_tree(s, optim.state_specs(api.param_specs(),
                                                         ocfg), rules)
            fn = cell.fn if rules else make_train_step(api, cfg, ocfg)
            with use_backend("reference", device="cpu"):
                _, _, loss = fn(p, s, batch)
            out.append((loss, p))
    (l0, p0), (l1, p1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a.detach(), b.to_local())
               for a, b in zip(tree_leaves(p0), tree_leaves(p1)))


SSM_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
_SSM_RANK = textwrap.dedent(_GRADS0) + textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)            # four ranks share the host's cores
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    from repro_torch.backend import use_backend
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import rules_for_mesh, start_mesh, stop_mesh
    from repro_torch.models import model_api
    from repro_torch.models.shardlib import distribute_tree
    inputs = torch.load(f"{tmp}/inputs.pt", weights_only=True)
    mesh = start_mesh((2, 2), ("data", "model"), backend="gloo", rank=rank,
                      store_path=f"{tmp}/store")
    rules = rules_for_mesh(mesh)
    out = {}
    for arch, (params, batch) in inputs.items():
        api = model_api(get_config(arch, smoke=True), device="cpu")
        params = distribute_tree(params, api.param_specs(), rules)
        with use_backend("reference", device="cpu"):
            out[arch] = grads0(api, params, batch, rules)[0]
    if rank == 0:
        torch.save(out, f"{tmp}/grads.pt")
    stop_mesh()
""")


@pytest.fixture(scope="module")
def ssm_mesh_grads(tmp_path_factory):
    """Step 0's gradients of rwkv6 and zamba2 smoke on ``reference``: on a
    4-rank gloo (2, 2) mesh (gathered whole), and without a mesh."""
    tmp = tmp_path_factory.mktemp("ssm_mesh")
    inputs = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch, smoke=True)
        inputs[arch] = (model_api(cfg, device="cpu").init_params(0),
                        _batch(cfg, 4, 32))
    torch.save(inputs, tmp / "inputs.pt")
    procs = [_spawn(_SSM_RANK, (rank, tmp)) for rank in range(4)]
    alone = {}
    for arch, (params, batch) in inputs.items():
        api = model_api(get_config(arch, smoke=True), device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with use_backend("reference", device="cpu"):
            alone[arch] = torch.autograd.grad(api.train_loss(params, batch),
                                              leaves)
    _finish(procs)
    return torch.load(tmp / "grads.pt", weights_only=True), alone


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_gradients_on_a_4_rank_mesh_match_no_mesh(ssm_mesh_grads, arch):
    meshed, alone = ssm_mesh_grads
    got, want = tree_leaves(meshed[arch]), alone[arch]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = (t.detach().to(torch.float64).numpy() for t in (g, w))
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_one_rank_mesh_serving_steps_of_the_other_families(arch):
    cfg = get_config(arch, smoke=True)
    api = model_api(cfg, device="cpu")
    params = api.init_params(0)
    dshape = ShapeConfig("d", 32, 2, "decode")
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    with _mesh((1, 1), "gloo") as mesh:
        dcell = steps.build_cell(arch, dshape, mesh, smoke=True)
        dparams = distribute_tree(params, api.param_specs(), dcell.rules)
        with use_backend("reference", device="cpu"):
            if cfg.family == "encdec":
                frames = torch.randn(
                    (2, 32 // cfg.enc_frames_ratio, cfg.d_model),
                    generator=torch.Generator().manual_seed(4)).to(
                        torch.bfloat16)
                prompt = {"tokens": torch.tensor([[3, 9, 4], [5, 1, 8]],
                                                 dtype=torch.int32),
                          "frames": frames}
                pcell = steps.build_cell(arch, ShapeConfig("p", 32, 2,
                                                           "prefill"),
                                         mesh, smoke=True)
                want, state = api.prefill(params, prompt, max_len=32)
                got, dstate = pcell.fn(dparams, prompt)
                assert torch.equal(want, got.full_tensor())
            else:
                state = api.make_decode_state(dshape)
                dstate = distribute_tree(api.make_decode_state(dshape),
                                         api.decode_state_specs(dshape),
                                         dcell.rules)
            for _ in range(3):
                want, state = api.decode_step(params, state, tok)
                got, dstate = dcell.fn(dparams, dstate, tok)
                assert torch.equal(want, got.full_tensor())
                tok = want.argmax(-1, keepdim=True).to(torch.int32)
        for a, b in zip(tree_leaves(state), tree_leaves(dstate)):
            assert torch.equal(a, b.full_tensor()
                               if hasattr(b, "full_tensor") else b)
