"""The gradient of the bf16 WKV recurrence (the JAX package's
``cfg.ssm_bf16=True``) in the port, on the CPU:
``wkv6_backward_plain(..., compute_dtype=torch.bfloat16)`` (the CPU's route
and the card's oracle for ``csrc/wkv6_bwd.cu``'s ``wkv6_bwd_bf16_launch``)
against ``jax.grad`` of the reference's ``wkv6_chunked(...,
compute_dtype=jnp.bfloat16)`` run op by op (``jax.disable_jit()``: compiled,
XLA rounds bf16 at other places); the autograd route; the CUDA source's
bf16 variant.

Tolerances, as fractions of the reference's largest magnitude in each
gradient: dr, dk and dv within 2^-7 (one bf16 step of the largest value:
the f32 sum behind a product runs in another order than XLA's, so now and
then a value rounds to the neighbouring bf16 one), and where a chunk holds
more than one row at least 4 times closer (relative Frobenius norm) to the
reference than the f32 backward on the same values: the test proves the
roundings, not only the answer.  dw_log within 2^-7; its separation from
the f32 route is recorded (``record_property``), not held: compiled, XLA
moves it almost as far as the f32 route does.  du and dstate, f32 in both,
within 2e-5.

The inputs keep each chunk's total decay above -30, where the reference
clamps its tail, chunk decay and carried-state factor at +-30 and the port
at +-60 (as ``tests/test_torch_wkv6_grad.py``).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as wmod
from repro_torch.kernels.wkv6 import wkv6, wkv6_backward_plain, wkv6_plain

BF16_TOL = 2.0 ** -7
F32_TOL = 2e-5
SEPARATION = 4.0
NAMES = ("dr", "dk", "dv", "dw_log", "du", "dstate")
#: (b, s, h, p, chunk): several chunks, wider heads, a ragged chunk (12
#: rows), one row a chunk
CASES = [(2, 64, 2, 16, 16), (1, 128, 3, 32, 32), (2, 12, 2, 8, 12),
         (2, 16, 2, 8, 1)]
CSRC = _build.CSRC_DIR


def _inputs(b, s, h, p, seed):
    """r, k, v ~ N(0, 1) rounded to bf16 (the model hands them over in
    bf16); w_log = -0.3 exp(N(0, 1/4)); u, state ~ N(0, 0.01); the output
    gradients dy, dS ~ N(0, 1), f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    w = (-0.3 * np.exp(rng.standard_normal((b, s, h, p)) * 0.5)).astype(
        np.float32)
    u = (rng.standard_normal((h, p)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, p)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dS = rng.standard_normal((b, h, p, p)).astype(np.float32)
    rkv = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)]
    rest = [torch.from_numpy(x) for x in (w, u, s0)]
    return rkv + rest, torch.from_numpy(dy), torch.from_numpy(dS)


@functools.lru_cache(maxsize=None)
def _case(b, s, h, p, chunk):
    """(inputs, dy, dS, the reference's gradients as f32 numpy): each
    shape's op-by-op ``jax.grad`` once for every test of it."""
    args, dy, dS = _inputs(b, s, h, p, seed=s + chunk)
    jargs = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
             for t in args[:3]] + [jnp.asarray(t.numpy()) for t in args[3:]]
    jdy, jdS = jnp.asarray(dy.numpy()), jnp.asarray(dS.numpy())

    def loss(*a):
        y, S = jssm.wkv6_chunked(*a, chunk, compute_dtype=jnp.bfloat16)
        return jnp.sum(y * jdy) + jnp.sum(S * jdS)
    with jax.disable_jit():
        want = jax.grad(loss, argnums=tuple(range(6)))(*jargs)
    return args, dy, dS, [np.asarray(w, np.float32) for w in want]


def _f32(t):
    return t.float().numpy()


def _fro(got, want):
    return float(np.linalg.norm((got - want).ravel())
                 / np.linalg.norm(want.ravel()))


@pytest.mark.parametrize("b,s,h,p,chunk", CASES, ids=str)
def test_bf16_backward_rounds_where_jax_grad_rounds(b, s, h, p, chunk,
                                                    record_property):
    """dr, dk and dv: bf16, within one bf16 step of the reference and (a
    chunk of more than one row) at least SEPARATION times closer than the
    f32 backward on the same values; dw_log within 2^-7, its separation
    recorded."""
    args, dy, dS, want = _case(b, s, h, p, chunk)
    got = wkv6_backward_plain(*args, dy, dS, chunk=chunk)
    f32 = wkv6_backward_plain(*args, dy, dS, chunk=chunk,
                              compute_dtype=torch.float32)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    for i, name in enumerate(NAMES[:4]):
        g, f, w = _f32(got[i]), _f32(f32[i]), want[i]
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_TOL * scale,
                                   err_msg=name)
        sep = _fro(f, w) / max(_fro(g, w), 1e-30)
        record_property(f"{name}_separation", sep)
        if chunk > 1 and name != "dw_log":
            assert sep >= SEPARATION, (name, _fro(g, w), _fro(f, w))


@pytest.mark.parametrize("b,s,h,p,chunk", CASES, ids=str)
def test_bf16_backward_keeps_du_and_dstate_f32(b, s, h, p, chunk):
    """du and dstate stay f32 in the reference's bf16 form, and within
    F32_TOL of it."""
    args, dy, dS, want = _case(b, s, h, p, chunk)
    got = wkv6_backward_plain(*args, dy, dS, chunk=chunk)
    for i in (4, 5):
        w = want[i]
        np.testing.assert_allclose(_f32(got[i]), w, rtol=0,
                                   atol=F32_TOL * np.abs(w).max(),
                                   err_msg=NAMES[i])


def test_autograd_route_returns_bf16_gradients_and_honours_needs():
    """``wkv6`` under autograd on bf16 r/k/v: y and the state of the plain
    bf16 forward bit for bit, the gradients of the plain bf16 backward in
    the inputs' dtypes (bf16 for r, k, v), none where no input asks, and
    no kernel launch on the CPU."""
    args, dy, dS = _inputs(2, 24, 2, 8, seed=3)
    launches = (wkv6.bf16_launches, wkv6.backward_launches,
                wkv6.bf16_backward_launches)
    leaves = [t.clone() for t in args]
    for i in (0, 1, 3):                     # r, k and w_log only
        leaves[i].requires_grad_(True)
    y, S = wkv6(*leaves, chunk=8)
    y0, S0 = wkv6_plain(*args, chunk=8, compute_dtype=torch.bfloat16)
    assert torch.equal(y.detach(), y0) and torch.equal(S.detach(), S0)
    assert "WKV6Fn" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y, S), [leaves[i] for i in (0, 1, 3)],
                              (dy, dS))
    want = wkv6_backward_plain(*args, dy, dS, chunk=8)
    for g, i in zip(got, (0, 1, 3)):
        assert g.dtype == args[i].dtype
        assert torch.equal(g, want[i])
    # v alone, and y's gradient alone: the state's is zero
    v = args[2].clone().requires_grad_(True)
    (dv,) = torch.autograd.grad(wkv6(*args[:2], v, *args[3:], chunk=8)[0],
                                [v], dy)
    assert torch.equal(dv, wkv6_backward_plain(*args, dy, None, chunk=8)[2])
    assert (wkv6.bf16_launches, wkv6.backward_launches,
            wkv6.bf16_backward_launches) == launches


def test_a_non_cpu_tensor_goes_to_the_kernel_or_raises():
    """The plain versions serve CPU tensors only: bf16 operands on another
    device under autograd reach the kernels' launcher, which has none for
    it, and raise (no fallback)."""
    args, _, _ = _inputs(1, 16, 2, 8, seed=4)
    meta = [t.to("meta") for t in args]
    meta[0].requires_grad_(True)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wkv6(*meta, chunk=8)


def test_cuda_sources_export_the_bf16_backward_and_bind_it():
    """``wkv6_bf16_passes_launch`` (the forward's passes kept) and
    ``wkv6_bwd_bf16_launch``: the state, fused, row and column passes
    templates on r/k/v's type, the five intra-chunk products on the bf16
    tensor cores (``product_bf16`` / ``product_bf16x2``, shared from
    ``tf32_tiles.cuh``; the fused pass reads bf16 v as bf16x2 pairs), the
    state products 3xTF32, no float atomics, no fast exponentials;
    ``_build`` declares both entry points."""
    fwd = (CSRC / "wkv6.cu").read_text()
    bwd = (CSRC / "wkv6_bwd.cu").read_text()
    tiles = (CSRC / "tf32_tiles.cuh").read_text()
    flat = " ".join(bwd.split())
    assert 'extern "C" int wkv6_bf16_passes_launch(' in fwd
    assert "return launch<__nv_bfloat16>(" in " ".join(fwd.split())
    assert 'extern "C" int wkv6_bwd_bf16_launch(' in bwd
    assert "return launch<__nv_bfloat16>(" in flat
    assert "return launch<float>(" in flat
    for kernel, bounds in (("wkv6_bwd_state_kernel", "THREADS, 3"),
                           ("wkv6_bwd_fused_kernel", "THREADS, 1"),
                           ("wkv6_bwd_row_kernel", "THREADS"),
                           ("wkv6_bwd_col_kernel", "THREADS")):
        assert re.search(rf"template <class T>\n__global__ void "
                         rf"__launch_bounds__\({bounds}\)\n{kernel}\("
                         rf"const T\* __restrict__", bwd), kernel
    # dA, drr (row pass); A, dA, A^T dy1, dA^T rr (column pass): mm_in on
    # the bf16 tensor cores where BF, each product rounded once; the fused
    # pass: A by mm_in, dA = dy1 v^T with v's bf16x2 pairs read as they
    # were staged, drr, A^T dy1 and dA^T rr on product_bf16
    assert flat.count("mm_in<BF>(") == 7
    assert "product_bf16(acc, a, b, warp_tile()" in flat
    assert flat.count("product_bf16(") == 4 and flat.count("product_bf16x2(") == 1
    assert "*reinterpret_cast<const uint32_t*>(Vt + s * LT + q)" in flat
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in tiles
    for helper in ("float round_bf16(", "uint32_t pack_bf16(",
                   "void mma_bf16(", "void product_bf16(",
                   "void product_bf16x2(", "float widen("):
        assert helper in tiles and helper not in fwd + bwd, helper
    # the reference's order: (state + u) + the intra-chunk term, rounded
    # (the row and column passes' three, and the fused pass's)
    assert flat.count("round_bf16(__fadd_rn( round_bf16(__fadd_rn(") == 6
    assert flat.count("round_bf16(dvi[si][jj][i])") == 2
    assert "to_shared<BF>(drr, Ks)" in flat and "to_shared<BF>(dkk, Sa)" in flat
    assert "rnd<BF>(drr[si][jj][i])" in flat and "rnd<BF>(dkk[si][jj][i])" in flat
    for src in (fwd, bwd, tiles):
        assert not re.findall(r"atomic\w*\(", src)
        assert "__expf" not in src and "fmaf" not in src
    # f32 products only through the 3xTF32 split
    assert "mma_tf32(" not in bwd and "product_3xtf32(" in bwd
    assert "narrow<T>(" in flat and "T* __restrict__ dr" in flat

    class Fn:
        argtypes = restype = None

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn
    lib = Lib()
    _build._declare(lib)
    assert lib.wkv6_bf16_passes_launch.argtypes == lib.wkv6_launch.argtypes
    assert lib.wkv6_bwd_bf16_launch.argtypes == lib.wkv6_bwd_launch.argtypes
    assert "wkv6_bf16_passes_launch" in wmod._launch.__code__.co_names
    assert "wkv6_bwd_bf16_launch" in wmod.wkv6_backward.__code__.co_names
