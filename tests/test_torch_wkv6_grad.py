"""The gradient of the port's ``wkv6`` on the CPU: ``wkv6_backward_plain``
(the CPU's route and the card's oracle for ``csrc/wkv6_bwd.cu``), reached
through ``wkv6`` under autograd (``_WKV6Fn``), against three others on the
same numpy-seeded inputs and output gradients:

* ``torch.autograd`` through ``wkv6_plain``: both f32, the same products
  summed in other orders (einsum against the chunk-by-chunk carry), within
  ``TOL_TORCH`` = 1e-5 of each gradient's largest magnitude (measured: under
  1e-6);
* ``jax.grad`` of the reference's chunked form
  (``repro.models.ssm.wkv6_chunked``), op by op (``jax.disable_jit()``) in
  one case and compiled in the others (f32 throughout: compiling moves only
  f32 roundings, and op by op one case takes seconds), within ``TOL_JAX`` =
  2e-5 (measured: under 1e-6, and 8e-6 where the chunk's decays pass
  exp(-30));
* the Pallas kernel ``repro.kernels.wkv6.wkv6`` at ``interpret=True``.  Its
  ``pallas_call`` has no working JVP under the JAX this repo runs (the rule
  asserts on the kernel), so its derivative is taken by central differences,
  along a random direction in one input at a time, in f32: within
  ``TOL_FD`` = 2e-3 of the sum of |g . t| (the differences' rounding and
  truncation stay near 1e-4 at the step taken).

The inputs keep each chunk's total decay above -30 where the reference
clamps its tail, chunk decay and carried-state factor at +-30 and the port
at +-60 (ROADMAP C6); one case runs decays of the model's size over chunks
of 64 and 128 rows, where the reference's clamps bind and the port's do not:
the factors there lie below exp(-30), and the gradients agree within the
same tolerance (no split to record).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as pallas_wkv6
from repro.models import ssm as jssm
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels.wkv6 import (wkv6, wkv6_backward_plain,
                                      wkv6_plain)

TOL_TORCH, TOL_JAX, TOL_FD = 1e-5, 2e-5, 2e-3
NAMES = ("r", "k", "v", "w_log", "u", "state")
# (b, s, h, p, chunk): the JAX tests' shapes, chunk = s, a ragged chunk
# (12 rows), one row a chunk
CASES = [(2, 64, 2, 16, 16), (1, 128, 3, 32, 32), (2, 32, 1, 8, 32),
         (2, 12, 2, 8, 12), (2, 16, 2, 8, 1)]


def _inputs(b, s, h, p, seed, scale=0.3):
    """r, k, v ~ N(0, 1); w_log = -scale exp(N(0, 1/4)); u, state ~
    N(0, 0.01); the output gradients dy, dS ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    w = (-scale * np.exp(rng.standard_normal((b, s, h, p)) * 0.5)).astype(
        np.float32)
    u = (rng.standard_normal((h, p)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, p)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dS = rng.standard_normal((b, h, p, p)).astype(np.float32)
    return [r, k, v, w, u, s0], dy, dS


def _t(a):
    return torch.from_numpy(np.array(a))


def _plain_grads(args, dy, dS, chunk):
    return wkv6_backward_plain(*map(_t, args), _t(dy),
                               None if dS is None else _t(dS), chunk=chunk)


def _close(got, want, tol, what):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what}: d{name}")


@pytest.mark.parametrize("state_grad", [False, True])
@pytest.mark.parametrize("b,s,h,p,chunk", CASES)
def test_backward_plain_matches_torch_autograd(b, s, h, p, chunk,
                                               state_grad):
    args, dy, dS = _inputs(b, s, h, p, seed=chunk + s)
    leaves = [_t(a).requires_grad_(True) for a in args]
    y, S = wkv6_plain(*leaves, chunk=chunk)
    outs, grads = (y, S), (_t(dy), _t(dS))
    if not state_grad:
        outs, grads = (y,), (_t(dy),)
    want = torch.autograd.grad(outs, leaves, grads)
    got = _plain_grads(args, dy, dS if state_grad else None, chunk)
    assert all(g.dtype == torch.float32 for g in got)
    _close([g.numpy() for g in got], [w.numpy() for w in want], TOL_TORCH,
           "torch.autograd")


def _jax_grads(args, dy, dS, chunk):
    def loss(*a):
        y, S = jssm.wkv6_chunked(*a, chunk)
        return jnp.sum(y * dy) + jnp.sum(S * dS)
    return jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))


@pytest.mark.parametrize("b,s,h,p,chunk,scale,op_by_op", [
    (2, 32, 1, 8, 16, 0.3, True), *[(*c, 0.3, False) for c in CASES],
    (2, 64, 2, 16, 64, 1.0, False), (1, 128, 2, 16, 128, 1.0, False)])
def test_backward_plain_matches_jax_grad_of_the_chunked_form(
        b, s, h, p, chunk, scale, op_by_op):
    args, dy, dS = _inputs(b, s, h, p, seed=s + 7, scale=scale)
    if op_by_op:
        with jax.disable_jit():
            want = _jax_grads(args, dy, dS, chunk)
    else:
        want = jax.jit(_jax_grads, static_argnums=3)(args, dy, dS, chunk)
    got = _plain_grads(args, dy, dS, chunk)
    _close([g.numpy() for g in got], [np.asarray(w) for w in want], TOL_JAX,
           "jax.grad of wkv6_chunked")


@pytest.mark.parametrize("b,s,h,p,chunk", [(2, 32, 2, 8, 8),
                                           (1, 48, 2, 16, 16)])
def test_backward_plain_matches_the_pallas_kernel_by_central_differences(
        b, s, h, p, chunk):
    args, dy, dS = _inputs(b, s, h, p, seed=s)
    got = _plain_grads(args, dy, dS, chunk)
    rng = np.random.default_rng(s + 1)
    jdy, jdS = jnp.asarray(dy), jnp.asarray(dS)

    def objective(a):
        y, S = pallas_wkv6(*map(jnp.asarray, a), chunk=chunk,
                           interpret=True)
        return float(jnp.sum(y * jdy) + jnp.sum(S * jdS))
    for i, name in enumerate(NAMES):
        t = rng.standard_normal(args[i].shape).astype(np.float32)
        # a step of 1e-2 of the input's own scale
        eps = 1e-2 * float(np.abs(args[i]).max())
        plus, minus = list(args), list(args)
        plus[i] = (args[i] + eps * t).astype(np.float32)
        minus[i] = (args[i] - eps * t).astype(np.float32)
        # the step as the inputs hold it, after their f32 rounding
        fd = (objective(plus) - objective(minus)) / (
            2 * eps * float(np.sum(t * t)))
        g = got[i].numpy()
        want = float(np.sum(g * t)) / float(np.sum(t * t))
        size = float(np.sum(np.abs(g * t))) / float(np.sum(t * t))
        assert abs(fd - want) <= TOL_FD * size, (name, fd, want, size)


def test_autograd_route_gives_the_plain_backward_and_honours_needs():
    """``wkv6`` under autograd returns y and the state of ``wkv6_plain``
    bit for bit, its gradients are ``wkv6_backward_plain``'s (cast to each
    input's dtype), inputs that need none get none, and the CPU launches no
    backward kernel."""
    args, dy, dS = _inputs(2, 24, 2, 8, seed=3)
    before = wkv6_mod.wkv6.backward_launches
    leaves = [_t(a) for a in args]
    for i in (0, 2, 3):                     # r, v and w_log only
        leaves[i].requires_grad_(True)
    y, S = wkv6(*leaves, chunk=8)
    y0, S0 = wkv6_plain(*map(_t, args), chunk=8)
    assert torch.equal(y.detach(), y0) and torch.equal(S.detach(), S0)
    assert y.grad_fn is not None and "WKV6Fn" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y, S), [leaves[i] for i in (0, 2, 3)],
                              (_t(dy), _t(dS)))
    want = _plain_grads(args, dy, dS, 8)
    for g, i in zip(got, (0, 2, 3)):
        assert torch.equal(g, want[i])
    # u as float64: its gradient comes back float64
    u64 = _t(args[4]).double().requires_grad_(True)
    y, _ = wkv6(*map(_t, args[:4]), u64, _t(args[5]), chunk=8)
    (du,) = torch.autograd.grad(y, u64, _t(dy))
    assert du.dtype == torch.float64
    assert wkv6_mod.wkv6.backward_launches == before


def test_inference_path_is_unchanged():
    """Without autograd recording (``no_grad``, ``inference_mode``, or no
    input needing a gradient) ``wkv6`` takes the forward-only route: no
    graph, the plain version's bits, ``state_out`` written in place."""
    args, _, _ = _inputs(1, 16, 2, 8, seed=4)
    want = wkv6_plain(*map(_t, args), chunk=8)
    leaves = [_t(a).requires_grad_(True) for a in args]
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            y, S = wkv6(*leaves, chunk=8)
        assert y.grad_fn is None
        assert torch.equal(y, want[0]) and torch.equal(S, want[1])
    state = _t(args[5])
    y, S = wkv6(*map(_t, args[:5]), state, chunk=8, state_out=state)
    assert S is state and torch.equal(state, want[1])


def test_state_out_under_autograd_raises():
    args, _, _ = _inputs(1, 16, 2, 8, seed=5)
    leaves = [_t(a).requires_grad_(True) for a in args]
    with pytest.raises(ValueError, match="state_out"):
        wkv6(*leaves, chunk=8, state_out=torch.zeros(1, 2, 8, 8))


def test_bf16_under_autograd_routes_to_the_bf16_backward(monkeypatch):
    """bf16 r, k and v under autograd take the bf16 recurrence both ways:
    the plain bf16 forward and ``wkv6_backward_plain`` with
    ``compute_dtype=bfloat16`` (bf16 gradients for r, k, v); f32 operands
    the f32 ones."""
    args, dy, _ = _inputs(1, 16, 2, 8, seed=5)
    seen = []
    real = wkv6_mod.wkv6_backward_plain

    def spy(*a, **kw):
        seen.append(kw["compute_dtype"])
        return real(*a, **kw)
    monkeypatch.setattr(wkv6_mod, "wkv6_backward_plain", spy)
    for dt in (torch.bfloat16, torch.float32):
        leaves = [_t(a).to(dt).requires_grad_(True) for a in args[:3]]
        y, _ = wkv6(*leaves, *map(_t, args[3:]), chunk=8)
        assert torch.equal(y.detach(), wkv6_plain(
            *[x.detach() for x in leaves], *map(_t, args[3:]), chunk=8,
            compute_dtype=dt)[0])
        grads = torch.autograd.grad(y, leaves, _t(dy))
        assert seen[-1] == dt and all(g.dtype == dt for g in grads)
    assert seen == [torch.bfloat16, torch.float32]
