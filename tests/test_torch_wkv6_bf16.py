"""The bf16 WKV recurrence (the JAX package's ``cfg.ssm_bf16=True``) in the
port, on the CPU: ``wkv6_plain(..., compute_dtype=torch.bfloat16)`` and the
model's ``wkv6_chunked`` against the reference's ``wkv6_chunked(...,
compute_dtype=jnp.bfloat16)`` run op by op; the wrapper's routing by the
operands' dtype; the CUDA source's bf16 variant; the mesh route.

Tolerances, as fractions of the reference's largest magnitude: y within
2^-8 (the f32 sum behind a score or the intra-chunk output runs in another
order than XLA's, so now and then one of them rounds to the neighbouring
bf16 value, a step of 2^-8 to 2^-7 of that value, which lies below the
largest), the final state within 1e-5 (it stays f32).  Where a chunk holds
more than one row, the bf16 route must also lie closer to the reference's
bf16 result than the f32 route does (at least 4 times closer): the test
proves the roundings, not only the answer.  At chunk 1 every score is
masked and the two routes are one.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as wmod
from repro_torch.kernels.wkv6 import compute_dtype_of, wkv6, wkv6_plain
from repro_torch.models import ssm as tssm

Y_TOL = 2.0 ** -8
STATE_TOL = 1e-5
SRC = (_build.CSRC_DIR / "wkv6.cu").read_text()


def _inputs(b, s, h, p, seed, decay=0.5):
    """r, k, v rounded to bf16 (the model hands them over in bf16), the
    decays, bonus and state in f32, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    w = -np.exp(rng.standard_normal((b, s, h, p)) * decay).astype(np.float32)
    u = (rng.standard_normal((h, p)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, p)) * 0.1).astype(np.float32)
    jax_in = [jnp.asarray(x).astype(jnp.bfloat16) for x in (r, k, v)] + [
        jnp.asarray(x) for x in (w, u, s0)]
    torch_in = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)] + [
        torch.from_numpy(x) for x in (w, u, s0)]
    return jax_in, torch_in


def _ref(jax_in, chunk):
    with jax.disable_jit():
        y, S = jssm.wkv6_chunked(*jax_in, chunk, compute_dtype=jnp.bfloat16)
    return np.asarray(y, np.float32), np.asarray(S, np.float32)


def _err(got, want):
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


#: (b, s, h, p, model chunk): chunk 1, one chunk, several chunks, a ragged
#: remainder (16 does not divide 20: the model's rule takes the whole
#: sequence), one decode step, a wider head
SHAPES = [(2, 8, 3, 8, 1), (2, 16, 2, 16, 16), (1, 64, 2, 16, 16),
          (2, 20, 2, 16, 16), (3, 1, 2, 16, 64), (1, 48, 4, 32, 16)]


@pytest.mark.parametrize("b,s,h,p,chunk", SHAPES, ids=str)
def test_bf16_plain_matches_the_reference_bf16_recurrence(b, s, h, p, chunk):
    jax_in, torch_in = _inputs(b, s, h, p, seed=s + chunk)
    want_y, want_S = _ref(jax_in, chunk)
    ch = tssm._chunk(chunk, s)
    y, S = wkv6_plain(*torch_in, chunk=ch, compute_dtype=torch.bfloat16)
    assert y.dtype == S.dtype == torch.float32
    assert _err(y, want_y) <= Y_TOL and _err(S, want_S) <= STATE_TOL
    # the model's form: one wrapper call at the model's chunk, bf16 operands
    my, mS = tssm.wkv6_chunked(*torch_in, chunk,
                               compute_dtype=torch.bfloat16)
    assert torch.equal(my, y) and torch.equal(mS, S)
    # f32 operands are rounded to bf16 first, as the reference's astype
    f32_in = [t.to(torch.float32) for t in torch_in[:3]] + torch_in[3:]
    fy, _ = tssm.wkv6_chunked(*f32_in, chunk, compute_dtype=torch.bfloat16)
    assert torch.equal(fy, y)
    # the f32 route on the same operands
    y32, _ = wkv6_plain(*torch_in, chunk=ch, compute_dtype=torch.float32)
    assert torch.equal(wkv6_plain(*torch_in, chunk=ch)[0], y)
    if ch > 1:
        assert _err(y, want_y) * 4 <= _err(y32, want_y)
    else:
        assert torch.equal(y32, y)


def test_bf16_rounds_where_the_reference_rounds():
    """One chunk of 4 rows by hand: rr, kk, the scores and the intra-chunk
    output are bf16 values; the u term and the carried state's term are
    added in f32."""
    _, (r, k, v, w, u, s0) = _inputs(1, 4, 1, 8, seed=3)
    y, _ = wkv6_plain(r, k, v, w, u, s0, chunk=4,
                      compute_dtype=torch.bfloat16)
    f = torch.float32
    rc, kc, vc = (x.to(f)[0, :, 0] for x in (r, k, v))
    lw = torch.cumsum(w[0, :, 0], 0)
    lw_prev = torch.cat([torch.zeros(1, 8), lw[:-1]])
    m = 0.5 * lw[-1:]

    def bf(x):
        return x.to(torch.bfloat16).to(f)
    rr = bf(rc * bf(torch.exp(lw_prev - m)))
    kk = bf(kc * bf(torch.exp(m - lw)))
    A = torch.tril(bf(rr @ kk.T), diagonal=-1)
    intra = bf(bf(A) @ vc)
    diag = (rc * u[0] * kc).sum(-1)
    inter = (rc * torch.exp(torch.clamp(lw_prev, max=0.0))) @ s0[0, 0]
    want = intra + diag[:, None] * vc + inter
    torch.testing.assert_close(y[0, :, 0], want, rtol=1e-6, atol=1e-6)
    for x in (rr, kk, A, intra):
        assert torch.equal(bf(x), x)


def test_the_wrapper_routes_by_the_operands_dtype(monkeypatch):
    _, (r, k, v, w, u, s0) = _inputs(1, 8, 2, 8, seed=5)
    assert compute_dtype_of(r, k, v) == torch.bfloat16
    f = [t.to(torch.float32) for t in (r, k, v)]
    assert compute_dtype_of(*f) == torch.float32
    assert compute_dtype_of(r.half(), k.half(), v.half()) == torch.float32
    with pytest.raises(ValueError, match="all be bfloat16"):
        wkv6(r, f[1], v, w, u, s0, chunk=4)
    seen = []
    real = wmod.wkv6_plain

    def spy(*args, **kw):
        seen.append(kw["compute_dtype"])
        return real(*args, **kw)
    monkeypatch.setattr(wmod, "wkv6_plain", spy)
    launches = (wkv6.launches, wkv6.bf16_launches)
    y, S = wkv6(r, k, v, w, u, s0, chunk=4)
    state = s0.clone()
    y2, S2 = wkv6(r, k, v, w, u, state, chunk=4, state_out=state)
    y3, _ = wkv6(*f, w, u, s0, chunk=4)
    assert seen == [torch.bfloat16, torch.bfloat16, torch.float32]
    assert S2 is state and torch.equal(y2, y) and torch.equal(S2, S)
    assert torch.equal(y, real(r, k, v, w, u, s0, chunk=4,
                               compute_dtype=torch.bfloat16)[0])
    assert not torch.equal(y3, y)
    # the CPU route launches nothing
    assert (wkv6.launches, wkv6.bf16_launches) == launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wkv6_plain(r, k, v, w, u, s0, chunk=4, compute_dtype=torch.float16)


def test_cuda_source_has_the_bf16_variant():
    """The same three passes and one-token kernel, instantiated for bf16
    r/k/v: the scores and the intra-chunk output on the bf16 tensor cores
    (m16n8k16, f32 accumulate), the reference's four roundings, the f32
    products still 3xTF32, and the launcher's entry point."""
    flat = " ".join(SRC.split())
    assert 'extern "C" int wkv6_bf16_launch(' in SRC
    assert "return launch<__nv_bfloat16>(" in flat
    assert "return launch<float>(" in flat
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in SRC
    for kernel in ("wkv6_state_kernel", "wkv6_scan_kernel"):
        assert re.search(rf"template <class T>\n__global__ void "
                         rf"__launch_bounds__\(THREADS, \d\)\n{kernel}\("
                         rf"const T\* __restrict__", SRC), kernel
    assert "template <bool VEC, class T>" in SRC
    # rr and kk: bf16(x * bf16(exp(.))); A and the intra-chunk sum rounded
    assert flat.count("round_bf16(__fmul_rn(x, round_bf16(f)))") == 2
    assert "round_bf16(sc[si][jj][i])" in flat
    assert "round_bf16(acc_in[si][jj][i])" in flat
    assert flat.count("product_bf16(") == 1 + 2
    assert flat.count("product_3xtf32(") == 1 + 3
    assert "fmaf" not in SRC and "__expf" not in SRC
    assert not re.findall(r"atomic\w*\(", SRC)


def test_the_mesh_route_passes_bf16_operands_through(monkeypatch):
    """``wkv6_chunked`` on ``DTensor`` operands (a one-rank gloo mesh, each
    rank's (batch, head) block through ``local_map``) hands the kernel bf16
    r/k/v and gives the unsharded call's bits."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import mesh as tmesh

    _, args = _inputs(2, 16, 2, 8, seed=9)
    want_y, want_S = tssm.wkv6_chunked(*args, 8, compute_dtype=torch.bfloat16)
    seen = []
    real = wmod.wkv6_plain

    def spy(r, k, v, *rest, **kw):
        seen.append((r.dtype, kw["compute_dtype"]))
        return real(r, k, v, *rest, **kw)
    monkeypatch.setattr(wmod, "wkv6_plain", spy)
    mesh = tmesh.start_mesh((1, 1), ("data", "model"), backend="gloo")
    try:
        dargs = [DTensor.from_local(t, mesh, [Replicate()] * 2,
                                    run_check=False) for t in args]
        y, S = tssm.wkv6_chunked(*dargs, 8, compute_dtype=torch.bfloat16)
        y, S = y.full_tensor(), S.full_tensor()
    finally:
        tmesh.stop_mesh()
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert torch.equal(y, want_y) and torch.equal(S, want_S)
