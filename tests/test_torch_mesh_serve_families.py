"""Serving of every model family not yet held on a 4-rank mesh, on the CPU.

On a ``gloo`` (2, 2) ("data", "model") mesh of 4 ranks (one process a rank,
spawned once for every config) on ``reference``: zamba2 (hybrid: decode
steps only, ``prefill`` raises for the family), llava (VLM: seeded patch
embeddings in front of a prompt longer than its 16-position window, so the
patch prefix and C3's window rule run on a split ring cache), grok and
llama4 (MoE), granite (MQA, one kv head), starcoder2 and qwen (qkv bias).
A seeded prompt is prefilled, then 6 decode steps cross the split cache's
boundary (two halves of 8 slots).  Each GEMM sums over a whole K on every
rank and each attention head runs whole, so every step's logits and the
final state's leaves are bit-equal (``torch.equal``) to the unsharded
steps' on the same tokens.

ROADMAP C13: that promise rests on B1's rows not depending on the rows
beside them.  The kernel's order is fixed by (K, N, dtype); its plain
version (the CPU's route) took the BLAS's float32 order, which changes
with M, b's layout and the threads, so qwen smoke's logits on the mesh
left the unsharded ones by one bf16 rounding (3.81e-6 at step 3).  The
plain version now sums in float64 and rounds once.
"""

import numpy as np
import pytest
import torch

from repro_torch.backend import get_backend, use_backend
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import model_api
from repro_torch.models.shardlib import tree_leaves
from test_torch_mesh import _finish, _spawn

#: in the order of the draws below (test_torch_mesh.py's serving test's)
ARCHS = ("zamba2-2.7b", "llava-next-mistral-7b", "grok-1-314b",
         "llama4-scout-17b-a16e", "granite-20b", "starcoder2-3b",
         "qwen1.5-110b")
MAX_LEN, STEPS = 16, 6
#: llava's prompt tokens beyond the 5 every prefilled arch draws: with its
#: 8 patches, 20 positions through a 16-slot window
LLAVA_MORE = 7

_RANK = """
    import sys
    import torch
    torch.set_num_threads(1)            # four ranks share the host's cores
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    from repro_torch.backend import get_backend, use_backend
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import start_mesh, stop_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model_api
    from repro_torch.models.shardlib import (distribute_tree, is_dtensor,
                                             tree_map)
    inputs = torch.load(f"{tmp}/inputs.pt", weights_only=True)
    mesh = start_mesh((2, 2), ("data", "model"), backend="gloo", rank=rank,
                      store_path=f"{tmp}/store")
    out = {}
    with use_backend(get_backend("reference", device="cpu")):
        for arch, run in inputs.items():
            api = model_api(get_config(arch, smoke=True), device="cpu")
            dshape = ShapeConfig("d", run["max_len"], 2, "decode")
            cell = build_cell(arch, dshape, mesh, smoke=True)
            params = distribute_tree(run["params"], api.param_specs(),
                                     cell.rules)
            logits = []
            if "prompt" in run:
                pcell = build_cell(arch, ShapeConfig(
                    "p", run["max_len"], 2, "prefill"), mesh, smoke=True)
                first, state = pcell.fn(params, run["prompt"])
                logits.append(first.full_tensor())
            else:
                state = distribute_tree(api.make_decode_state(dshape),
                                        api.decode_state_specs(dshape),
                                        cell.rules)
            for tok in run["feed"]:
                got, state = cell.fn(params, state, tok)
                logits.append(got.full_tensor())
            out[arch] = {"logits": logits, "state": tree_map(
                lambda t: t.full_tensor() if is_dtensor(t) else t, state)}
    if rank == 0:
        torch.save(out, f"{tmp}/port.pt")
    stop_mesh()
"""


def _inputs():
    """Per arch: seeded weights (``init_params(0)``), the decode steps'
    tokens and (but for zamba2) a prompt.  The draws from ``default_rng(7)``
    are test_torch_mesh.py's serving test's for these archs in this order
    (the finding of C13); llava's patches and its longer prompt come from a
    second generator."""
    rng, more = np.random.default_rng(7), np.random.default_rng(8)
    runs = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        feed = [torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 1))
                                 .astype(np.int32)) for _ in range(STEPS)]
        run = {"params": model_api(cfg, device="cpu").init_params(0),
               "feed": feed, "max_len": MAX_LEN}
        if cfg.family != "hybrid":
            toks = rng.integers(3, cfg.vocab_size, (2, 5))
            prompt = {}
            if cfg.frontend == "vision":
                toks = np.concatenate([toks, more.integers(
                    3, cfg.vocab_size, (2, LLAVA_MORE))], axis=1)
                prompt["patch_embeds"] = torch.from_numpy(
                    more.standard_normal((2, cfg.frontend_tokens,
                                          cfg.d_model)).astype(np.float32)
                ).to(torch.bfloat16)
            prompt["tokens"] = torch.from_numpy(toks.astype(np.int32))
            run["prompt"] = prompt
        runs[arch] = run
    return runs


def _alone(arch, run):
    """The unsharded steps on ``reference``: each step's logits and the
    final state."""
    api = model_api(get_config(arch, smoke=True), device="cpu")
    logits = []
    with use_backend("reference", device="cpu"):
        if "prompt" in run:
            first, state = api.prefill(run["params"], run["prompt"],
                                       max_len=run["max_len"])
            logits.append(first)
        else:
            state = api.make_decode_state(ShapeConfig("d", run["max_len"], 2,
                                                      "decode"))
        for tok in run["feed"]:
            got, state = api.decode_step(run["params"], state, tok)
            logits.append(got.clone())
    return {"logits": logits, "state": state}


@pytest.fixture(scope="module")
def mesh_serving(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    runs = _inputs()
    torch.save(runs, tmp / "inputs.pt")
    procs = [_spawn(_RANK, (rank, tmp)) for rank in range(4)]
    alone = {arch: _alone(arch, run) for arch, run in runs.items()}
    _finish(procs)
    return torch.load(tmp / "port.pt", weights_only=True), alone, runs


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_a_4_rank_mesh_is_bit_equal_to_no_mesh(mesh_serving,
                                                          arch):
    meshed, alone, runs = mesh_serving
    got, want = meshed[arch], alone[arch]
    steps = STEPS + ("prompt" in runs[arch])
    assert len(got["logits"]) == len(want["logits"]) == steps
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert torch.equal(g, w), (arch, i)
    g_leaves, w_leaves = tree_leaves(got["state"]), tree_leaves(
        want["state"])
    assert len(g_leaves) == len(w_leaves) > 1
    for g, w in zip(g_leaves, w_leaves):
        assert torch.equal(g, w), arch


def test_llava_prompt_runs_its_patches_past_the_window(mesh_serving):
    """The llava case prefills a patch prefix and more positions than its
    ring cache holds, and its decode steps cross the split's boundary."""
    _, _, runs = mesh_serving
    cfg = get_config("llava-next-mistral-7b", smoke=True)
    prompt = runs["llava-next-mistral-7b"]["prompt"]
    positions = prompt["patch_embeds"].shape[1] + prompt["tokens"].shape[1]
    assert positions > cfg.sliding_window == MAX_LEN
    slots = [(positions + i) % MAX_LEN for i in range(STEPS)]
    assert min(slots) < MAX_LEN // 2 <= max(slots)


def test_reference_rows_do_not_depend_on_the_rows_beside_them():
    """C13's cause, at the GEMM: qwen smoke's decode logits product, a
    (2, 128) x (128, 512) product through the tied embedding's transposed
    view, against each rank's block of it on a (2, 2) mesh (one row by a
    contiguous (128, 256) half); and rows of a K = 1024, N = 32 product at
    M = 1..5 against the same rows of an M = 64 one, whose float32 order
    the BLAS splits over threads.  Every row is bit-equal."""
    be = get_backend("reference", device="cpu")
    cfg = get_config("qwen1.5-110b", smoke=True)
    emb = model_api(cfg, device="cpu").init_params(0)["embedding"]
    gen = torch.Generator().manual_seed(13)
    half = cfg.vocab_size // 2
    for _ in range(4):
        x = torch.randn((2, cfg.d_model), generator=gen).to(torch.bfloat16)
        for precision in ("f32", None):
            whole, _ = be.matmul(x, emb.T, precision=precision)
            for r in range(2):
                for c in range(2):
                    block, _ = be.matmul(
                        x[r:r + 1], emb[c * half:(c + 1) * half].T
                        .contiguous(), precision=precision)
                    assert torch.equal(
                        block, whole[r:r + 1, c * half:(c + 1) * half])
    a = torch.randn((64, 1024), generator=gen).to(torch.bfloat16)
    b = (torch.randn((1024, 32), generator=gen) * 0.05).to(torch.bfloat16)
    whole, _ = be.matmul(a, b, precision="f32")
    for m in range(1, 6):
        rows, _ = be.matmul(a[:m], b, precision="f32")
        assert torch.equal(rows, whole[:m]), m
