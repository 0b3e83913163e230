"""The plan of the bf16 ``wkv6`` forward's kernels (B4 with bf16 r, k and
v), on the CPU.

The state and scan passes keep r, k and v in shared memory in their own
type: bf16 tiles staged by 16-byte ``cp.async`` copies where a tensor's
rows start 16-byte aligned (``rows16``, else clamped lane loads), rr, kk
and the scores stored as bf16 and read as bf16x2 pairs.  Here, without a
card: the per-type shared-memory budgets of ``csrc/wkv6.cu`` against
:mod:`repro_torch.kernels.wkv6`'s, the blocks an SM each kernel's
``__launch_bounds__`` claims against the SM's shared memory, the bf16 scan
block's layout, the rotation of its k / v slots (no slot written while
what it holds is still read), the staging decision (:func:`rows16`,
mirroring the source's) on the model's operands and on contiguous,
strided and offset tensors, and the grids and the passes' workspace, which
the backward kernel reads, left as they were.
"""

import dataclasses
import re

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as wmod
from repro_torch.kernels.wkv6 import pass_plan, rows16
from repro_torch.models import model_api
from repro_torch.models import ssm as tssm

SRC = (_build.CSRC_DIR / "wkv6.cu").read_text()
BWD = (_build.CSRC_DIR / "wkv6_bwd.cu").read_text()
FLAT = " ".join(SRC.split())
#: the SM's shared memory, the part kept per block, a block's largest ask
SM_BYTES, PER_BLOCK, BLOCK_MAX = 228 * 1024, 1024, 232448
TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _int(name):
    hit = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert hit, name
    return eval(hit.group(1), {},          # noqa: S307 (our own source)
                {"PMAX": 64, "TILE": 64})


def _typed(name, dtype):
    """A budget templated on the operand type, evaluated for ``dtype``."""
    hit = re.search(rf"template <class T>\nconstexpr int {name} =\s*"
                    rf"IS_BF16<T> \? ([^:]+) : ([^;]+);", SRC)
    assert hit, name
    expr = hit.group(1 if dtype == torch.bfloat16 else 2).strip()
    names = {k: _int(k) for k in ("TILE", "LDA", "LDB", "LDH")}
    return eval(expr, {}, names)           # noqa: S307 (our own source)


def _kernel_text(head):
    """The source of the kernel whose definition starts with ``head``, to
    the next kernel."""
    start = SRC.index(head)
    nxt = SRC.find("__global__", start + len(head))
    return SRC[start:nxt if nxt > 0 else None]


def _static_bytes(body):
    """Bytes of a kernel's static ``__shared__ float`` arrays."""
    total = 0
    for decl in re.findall(r"__shared__ float ([^;]+);", body):
        for size in re.findall(r"\[(\w+)\]", decl):
            total += 4 * {"PMAX": 64, "TILE": 64}[size]
    return total


#: (kernel head, the dtypes it serves)
KERNELS = {
    "state": ("template <class T>\n__global__ void __launch_bounds__(THREADS, "
              "{n})\nwkv6_state_kernel(", ("f32", "bf16")),
    "scan": ("template <class T>\n__global__ void __launch_bounds__(THREADS, "
             "{n})\nwkv6_scan_kernel(", ("f32",)),
    "scan_bf16": ("template <>\n__global__ void __launch_bounds__(THREADS, "
                  "{n})\nwkv6_scan_kernel<__nv_bfloat16>(", ("bf16",)),
}


def _launch_bounds(kind):
    head = KERNELS[kind][0]
    pattern = re.escape(head).replace(re.escape("{n}"), r"(\d+)")
    hit = re.search(pattern, SRC)
    assert hit, kind
    return int(hit.group(1)), hit.group(0)


@pytest.mark.parametrize("name", TYPES)
def test_shared_memory_budgets_are_the_cuda_sources(name):
    dt = TYPES[name]
    assert _typed("STATE_SMEM_BYTES", dt) == wmod.STATE_SMEM_BYTES[dt]
    assert _typed("SCAN_SMEM_BYTES", dt) == wmod.SCAN_SMEM_BYTES[dt]
    # each launch asks for its type's budget
    for text in ("wkv6_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemory"
                 "Size, STATE_SMEM_BYTES<T>);",
                 "cudaFuncAttributeMaxDynamicSharedMemorySize, "
                 "SCAN_SMEM_BYTES<T>);",
                 "THREADS, STATE_SMEM_BYTES<T>, st>>>",
                 "THREADS, SCAN_SMEM_BYTES<T>, st>>>"):
        assert text in FLAT, text
    # the state pass's bf16 tiles are half its f32 ones
    if dt == torch.bfloat16:
        assert (wmod.STATE_SMEM_BYTES[dt]
                < wmod.STATE_SMEM_BYTES[torch.float32])


@pytest.mark.parametrize("kind", KERNELS)
def test_blocks_per_sm_fit_as_the_launch_bounds_claim(kind):
    """Each kernel's ``__launch_bounds__`` names the blocks an SM it is
    built for; that many blocks of each type it serves fit the SM's 228 KB
    (1 KB kept per block, the static arrays beside the dynamic tiles), and
    one block's shared memory fits the 227 KB a block may ask for."""
    n, head = _launch_bounds(kind)
    static = _static_bytes(_kernel_text(head))
    for name in KERNELS[kind][1]:
        dt = TYPES[name]
        plan_n = (wmod.STATE_BLOCKS_PER_SM if kind == "state"
                  else wmod.SCAN_BLOCKS_PER_SM)[dt]
        assert n == plan_n
        dyn = (wmod.STATE_SMEM_BYTES if kind == "state"
               else wmod.SCAN_SMEM_BYTES)[dt]
        assert dyn + static <= BLOCK_MAX
        assert n * (dyn + static + PER_BLOCK) <= SM_BYTES
    if kind == "scan_bf16":              # two blocks an SM, as f32's
        assert n == 2


def test_bf16_scan_block_layout_fills_its_budget():
    """lw and r_state (f32, 68 a row), S_in (f32, 72 a row; the scores,
    bf16, over it once r_state S_in is done), then four bf16 tiles (72
    halves a row): r / rr and three slots for k and v; every region 16-byte
    aligned (cp.async, ldmatrix)."""
    tile, lda, ldb, ldh = (_int(k) for k in ("TILE", "LDA", "LDB", "LDH"))
    half_tile = tile * ldh * 2
    body = _kernel_text(KERNELS["scan_bf16"][0].format(n=2))
    for text in ("float* Ls = smem;", "float* Rs = Ls + TILE * LDA;",
                 "float* Si = Rs + TILE * LDA;",
                 "T* As = reinterpret_cast<T*>(Si);",
                 "T* Rr = reinterpret_cast<T*>(Si + TILE * LDB);",
                 "T* slots = Rr + HT;"):
        assert text in body, text
    offsets = [i * tile * lda * 4 for i in range(3)]            # Ls, Rs, Si
    offsets.append(offsets[-1] + tile * ldb * 4)                # Rr
    offsets += [offsets[-1] + i * half_tile for i in range(1, 4)]  # slots
    assert all(o % 16 == 0 for o in offsets)
    assert offsets[-1] + half_tile == wmod.SCAN_SMEM_BYTES[torch.bfloat16]
    assert half_tile <= tile * ldb * 4                          # A in S_in
    assert (ldh * 2) % 16 == 0 and (lda * 4) % 16 == 0
    # A goes over S_in only after every warp's r_state S_in
    flat = " ".join(body.split())
    assert (flat.index("product2_bf16x2_3xtf32(")
            < flat.index("if (sj == 0) __syncthreads();")
            < flat.index("store_pairs(sc, wt, As);"))


def _rotation(ti):
    """What each k / v slot holds through the bf16 scan's s-tile loop over
    row tile ti, in the source's order; asserts that every tile is where
    the slot arithmetic (ks = 2 sj mod 3) looks for it and that no slot is
    written while what it holds is still to be read.  Returns the slots
    each s tile's k and v were read from."""
    holds = {0: "k0", 1: "v0", 2: "free"}   # at the first s tile
    read = []
    for sj in range(ti + 1):
        ks = (2 * sj) % 3
        kb, vb, nxt = ks, (ks + 1) % 3, (ks + 2) % 3
        assert holds[kb] == f"k{sj}" and holds[vb] == f"v{sj}"
        if sj < ti:
            assert holds[nxt] == "free"      # kk and v are still read below
            holds[nxt] = f"k{sj + 1}"        # issued once kk is formed
            holds[kb] = f"v{sj + 1}"         # issued once the scores are
        assert holds[vb] == f"v{sj}"         # A v reads v
        read.append((kb, vb))
        holds[vb] = "free"
    return read


@pytest.mark.parametrize("ti", [0, 1, 2, 3, 15])
def test_bf16_scan_slots_rotate_without_overwriting_a_live_tile(ti):
    """Three slots carry k and v from s tile to s tile: once kk of tile sj
    is formed the next k goes to the free slot, once the scores are formed
    the next v goes where kk was; tile sj + 1 then finds its k and v where
    the source's slot arithmetic looks (ks = 2 sj mod 3)."""
    body = " ".join(_kernel_text(KERNELS["scan_bf16"][0].format(n=2)).split())
    for text in ("const int ks = (2 * sj) % 3;", "T* Kb = slots + ks * HT;",
                 "T* Vb = slots + (ks + 1) % 3 * HT;",
                 "stage_k(slots + (ks + 2) % 3 * HT, sj + 1);",
                 "stage_v(Kb, sj + 1);", "stage_v(slots + HT, 0);",
                 "stage_k(slots, 0);"):
        assert text in body, text
    # the next tile's loads are issued before this tile's products
    assert (body.index("stage_k(slots + (ks + 2) % 3 * HT, sj + 1);")
            < body.index("product2_bf16x2_3xtf32(")
            < body.index("product_bf16x2(sc, rr_of, kk_of")
            < body.index("stage_v(Kb, sj + 1);")
            < body.index("product_bf16_frags( acc_in,"))
    read = _rotation(ti)
    assert len(read) == ti + 1 and all(k != v for k, v in read)
    if ti >= 2:                          # every slot takes a k in turn
        assert {k for k, _ in read} == {0, 1, 2}


def test_staging_decision_mirrors_the_source():
    """``rows16`` is the launcher's rule: 16-byte copies where the base,
    the strides of b, s and h and p are multiples of 16 bytes' elements (8
    bf16, 4 f32), for bf16 r, k and v too; else lane loads."""
    for text in ("return aligned16(ptr) && sq.b % per == 0 && sq.s % per == 0"
                 " && sq.h % per == 0 && P % per == 0;",
                 "constexpr long long PER_T = 16 / sizeof(T);",
                 "(rows16(r, sr, PER_T) ? VEC_R : 0)",
                 "(rows16(k, sk, PER_T) ? VEC_K : 0)",
                 "(rows16(v, sv, PER_T) ? VEC_V : 0)",
                 "(rows16(w, sw, 4) ? VEC_W : 0)"):
        assert text in FLAT, text
    bf = torch.bfloat16
    dense = torch.zeros((2, 16, 3, 64), dtype=bf)
    assert rows16(dense) and rows16(dense.float())
    # chip_smoke.py's strided case: p 47, one element into a wider row
    wide = torch.zeros((2, 16, 12, 48), dtype=bf)
    assert not rows16(wide[..., 1:]) and not rows16(wide[..., :47])
    assert not rows16(wide[..., 1:].float())
    # a view one element off an aligned base: its rows start at 2 bytes
    flat = torch.zeros(2 * 16 * 3 * 64 + 8, dtype=bf)
    off = flat[1:1 + dense.numel()].view(dense.shape)
    assert off.stride() == dense.stride() and not rows16(off)
    assert rows16(flat[8:8 + dense.numel()].view(dense.shape))
    # a stride of h that is a multiple of 4 elements but not of 8: f32 only
    h4 = torch.zeros((2, 16, 3, 68), dtype=bf)[..., :64]
    assert not rows16(h4) and rows16(h4.float())


def test_the_models_operands_take_16_byte_copies(monkeypatch):
    """The model hands ``wkv6`` r, k and v made by ``.to(bfloat16)`` and
    ``.reshape`` of contiguous projections (``models/ssm.py``), so with
    ``ssm_bf16`` every operand is staged by 16-byte copies: rwkv6's smoke
    config on the CPU, each layer's call recorded."""
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", smoke=True),
                              ssm_bf16=True)
    api = model_api(cfg, device="cpu")
    params = api.init_params(0)
    seen, real = [], tssm.wkv6

    def record(r, k, v, w_log, u, state, *, chunk, **kw):
        seen.append((r, k, v, w_log))
        return real(r, k, v, w_log, u, state, chunk=chunk, **kw)
    monkeypatch.setattr(tssm, "wkv6", record)
    toks = torch.randint(3, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        api.loss(params, {"tokens": toks, "labels": toks})
    assert len(seen) == cfg.n_layers
    for ops in seen:
        assert [t.dtype for t in ops] == [torch.bfloat16] * 3 + [
            torch.float32]
        assert all(rows16(t) for t in ops)


#: (b, s, h, p, chunk): the loss and train shapes, ragged chunks, the
#: strided p 47 (chunk 128, and 1 under autograd's passes)
SHAPES = {(2, 2048, 32, 64, 64): ((64, 32, 1), (64, 4, 1), (64, 32, 1),
                                  16_908_288),
          (2, 256, 32, 64, 64): ((64, 4, 1), (64, 4, 1), (64, 4, 1),
                                 2_113_536),
          (1, 100, 32, 64, 100): ((32, 1, 1), (32, 4, 1), (32, 1, 2),
                                  337_920),
          (1, 1000, 32, 64, 1000): ((32, 1, 1), (32, 4, 1), (32, 1, 16),
                                    2_181_120),
          (2, 256, 12, 47, 128): ((24, 2, 1), (24, 3, 1), (24, 2, 2),
                                  397_056),
          (2, 3, 12, 47, 1): ((24, 3, 1), (24, 3, 1), (24, 3, 1), 165_816)}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_grids_and_the_passes_workspace_are_unchanged(shape):
    """The redesign moves no pass and no scratch: the grids and the passes'
    workspace (each chunk's incoming state, lw, the decays; what the
    backward kernel reads at the same offsets) keep their sizes."""
    state, carry, scan, floats = SHAPES[shape]
    plan = pass_plan(*shape)
    assert (plan.state_grid, plan.carry_grid, plan.scan_grid) == (
        state, carry, scan)
    assert plan.passes_workspace_floats == floats
    for text in ("const long long n_states = round4((long long)B * H * nc * P"
                 " * P);",
                 "const long long n_lw = round4((long long)B * S * H * P);"):
        assert text in FLAT and text in " ".join(BWD.split())
    assert "float* lw = states + n_states; float* dec = lw + n_lw;" in FLAT
    assert ("const float* lw = S_in + n_states; const float* dec = lw + "
            "n_lw;") in " ".join(BWD.split())
