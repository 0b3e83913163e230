"""The gradient of the port's ``ssd_chunk`` on the CPU:
``ssd_chunk_backward_plain`` (the CPU's route and the card's oracle for
``csrc/ssd_chunk_bwd.cu``), reached through ``ssd_chunk`` under autograd
(``_SSDChunkFn``), against three others on the same numpy-seeded inputs and
output gradients:

* ``torch.autograd`` through ``ssd_chunk_plain``: both f32, sums in other
  orders, within ``TOL_TORCH`` = 1e-5 of each gradient's largest magnitude,
  dA_log within ``TOL_TORCH_DA`` = 1e-4 (a sum over every row of a reverse
  cumsum whose terms cancel; measured up to 2e-5);
* ``jax.grad`` of the reference's SSD recurrence: its per-token oracle
  ``repro.kernels.ref.ssd`` (the same function where no clamp binds: each
  chunk's total decay stays above -30 here), op by op (``jax.disable_jit()``)
  in one case and compiled in the others (f32 throughout), within
  ``TOL_JAX`` = 2e-5, dA_log ``TOL_JAX_DA`` = 1e-4 (measured: 1e-6; dA_log
  9e-6); and the SSD core inside the reference's ``mamba2_forward``: one
  Mamba2 layer's gradients (its input and every parameter leaf) against
  ``jax.grad`` of the reference's layer op by op, within ``GRAD_TOL`` (the
  train tests' bf16 tolerance: the layer's GEMMs run in bf16);
* the Pallas kernel ``repro.kernels.ssd_chunk.ssd_chunk`` at
  ``interpret=True``, by central differences along a random direction in
  one input at a time (its ``pallas_call`` has no working JVP under the JAX
  this repo runs), within ``TOL_FD`` = 2e-3 of the sum of |g . t|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd_chunk
from repro.models import model_api as j_model_api
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.kernels.ssd_chunk import (ssd_chunk,
                                           ssd_chunk_backward_plain,
                                           ssd_chunk_plain)
from repro_torch.models import model_api
from repro_torch.models import ssm as tssm
from test_torch_train import GRAD_TOL

TOL_TORCH, TOL_TORCH_DA = 1e-5, 1e-4
TOL_JAX, TOL_JAX_DA = 2e-5, 1e-4
TOL_FD = 2e-3
NAMES = ("x", "dt", "A_log", "B", "C", "D", "state")
# (b, s, h, p, n, chunk): the JAX tests' shapes, a ragged chunk (12 rows)
# = s, a chunk = s, one row a chunk
CASES = [(2, 64, 2, 16, 8, 16), (1, 96, 4, 32, 16, 32), (2, 32, 1, 8, 4, 8),
         (2, 12, 2, 8, 4, 12), (1, 32, 2, 8, 4, 32), (1, 8, 2, 4, 4, 1)]


def _inputs(b, s, h, p, n, seed):
    """x, B, C, D, state ~ N(0, 1), dt = softplus(N(0, 1)) / 2 (each
    chunk's decay stays above exp(-30)), A_log ~ N(0, 0.09); the output
    gradients dy, dS ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.5 * np.logaddexp(rng.standard_normal((b, s, h)), 0)).astype(
        np.float32)
    A_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dS = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return [x, dt, A_log, B, C, D, s0], dy, dS


def _t(a):
    return torch.from_numpy(np.array(a))


def _plain_grads(args, dy, dS, chunk):
    return ssd_chunk_backward_plain(*map(_t, args), _t(dy),
                                    None if dS is None else _t(dS),
                                    chunk=chunk)


def _close(got, want, tol, tol_da, what):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        lim = (tol_da if name == "A_log" else tol) * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=lim,
                                   err_msg=f"{what}: d{name}")


@pytest.mark.parametrize("state_grad", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_backward_plain_matches_torch_autograd(b, s, h, p, n, chunk,
                                               state_grad):
    args, dy, dS = _inputs(b, s, h, p, n, seed=s + chunk)
    leaves = [_t(a).requires_grad_(True) for a in args]
    y, S = ssd_chunk_plain(*leaves, chunk=chunk)
    outs, grads = (y, S), (_t(dy), _t(dS))
    if not state_grad:
        outs, grads = (y,), (_t(dy),)
    want = torch.autograd.grad(outs, leaves, grads)
    got = _plain_grads(args, dy, dS if state_grad else None, chunk)
    assert all(g.dtype == torch.float32 for g in got)
    _close([g.numpy() for g in got], [w.numpy() for w in want], TOL_TORCH,
           TOL_TORCH_DA, "torch.autograd")


def _jax_grads(args, dy, dS):
    def loss(*a):
        y, S = jref.ssd(*a)
        return jnp.sum(y * dy) + jnp.sum(S * dS)
    return jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, args))


@pytest.mark.parametrize("b,s,h,p,n,chunk,op_by_op", [
    (2, 16, 1, 8, 4, 8, True), *[(*c, False) for c in CASES]])
def test_backward_plain_matches_jax_grad_of_the_recurrence(
        b, s, h, p, n, chunk, op_by_op):
    args, dy, dS = _inputs(b, s, h, p, n, seed=s + 5)
    if op_by_op:
        with jax.disable_jit():
            want = _jax_grads(args, dy, dS)
    else:
        want = jax.jit(_jax_grads)(args, dy, dS)
    got = _plain_grads(args, dy, dS, chunk)
    _close([g.numpy() for g in got], [np.asarray(w) for w in want], TOL_JAX,
           TOL_JAX_DA, "jax.grad of ref.ssd")


def test_a_mamba2_layers_gradients_match_jax_grad_of_the_reference_layer():
    """The SSD core in place: one Mamba2 layer (zamba2 smoke, a ragged
    chunk of 12 rows, dt_bias and A_log drawn at random) under autograd
    against ``jax.grad`` of the reference's ``mamba2_forward`` op by op:
    the input's and every parameter's gradient."""
    jcfg, tcfg = (j_get_config("zamba2-2.7b", smoke=True),
                  get_config("zamba2-2.7b", smoke=True))
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    specs = model_api(tcfg, device="cpu").param_specs()
    rng = np.random.default_rng(11)
    lp = {k: np.asarray(jnp.asarray(v[0]).astype(jnp.float32))
          for k, v in jparams["mamba"].items()}
    for k in ("A_log", "dt_bias"):
        lp[k] = (rng.standard_normal(lp[k].shape) * 0.5).astype(np.float32)
    jlp = {k: jnp.asarray(v).astype(jparams["mamba"][k].dtype)
           for k, v in lp.items()}
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)

    def jloss(x, lp):
        out = jssm.mamba2_forward(x, lp, jcfg)
        return jnp.sum(out.astype(jnp.float32) * w)
    with jax.disable_jit():
        jgx, jglp = jax.grad(jloss, argnums=(0, 1))(jx, jlp)
    tlp = {k: torch.from_numpy(np.array(v)).to(specs["mamba"][k].dtype)
           for k, v in lp.items()}
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    used = sorted(set(tlp) - {"norm"})     # the layer's norm is applied
    leaves = [tlp[k].requires_grad_(True) for k in used]   # by its caller
    out = tssm.mamba2_forward(tx, tlp, tcfg)
    got = torch.autograd.grad(
        torch.sum(out.to(torch.float32) * torch.from_numpy(w)),
        [tx] + leaves)
    want = [jgx] + [jglp[k] for k in used]
    for name, g, j in zip(["x"] + used, got, want):
        g = g.to(torch.float32).numpy()
        j = np.asarray(jnp.asarray(j).astype(jnp.float32))
        assert g.shape == j.shape, name
        np.testing.assert_allclose(g, j, rtol=0,
                                   atol=GRAD_TOL * np.abs(j).max(),
                                   err_msg=name)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 32, 2, 8, 4, 8),
                                             (1, 48, 3, 16, 8, 16)])
def test_backward_plain_matches_the_pallas_kernel_by_central_differences(
        b, s, h, p, n, chunk):
    args, dy, dS = _inputs(b, s, h, p, n, seed=s)
    got = _plain_grads(args, dy, dS, chunk)
    rng = np.random.default_rng(s + 1)
    jdy, jdS = jnp.asarray(dy), jnp.asarray(dS)

    def objective(a):
        y, S = pallas_ssd_chunk(*map(jnp.asarray, a), chunk=chunk,
                                interpret=True)
        return float(jnp.sum(y * jdy) + jnp.sum(S * jdS))
    for i, name in enumerate(NAMES):
        t = rng.standard_normal(args[i].shape).astype(np.float32)
        eps = 1e-2 * float(np.abs(args[i]).max())
        plus, minus = list(args), list(args)
        plus[i] = (args[i] + eps * t).astype(np.float32)
        minus[i] = (args[i] - eps * t).astype(np.float32)
        fd = (objective(plus) - objective(minus)) / (
            2 * eps * float(np.sum(t * t)))
        g = got[i].numpy()
        want = float(np.sum(g * t)) / float(np.sum(t * t))
        size = float(np.sum(np.abs(g * t))) / float(np.sum(t * t))
        assert abs(fd - want) <= TOL_FD * size, (name, fd, want, size)


def test_autograd_route_gives_the_plain_backward_and_honours_needs():
    """``ssd_chunk`` under autograd returns the plain version's y and state
    bit for bit, its gradients are ``ssd_chunk_backward_plain``'s, inputs
    that need none get none, ``state_out`` raises, and the CPU launches no
    backward kernel; without autograd recording the forward-only route
    runs (no graph)."""
    args, dy, dS = _inputs(2, 16, 2, 8, 4, seed=9)
    before = ssd_mod.ssd_chunk.backward_launches
    leaves = [_t(a) for a in args]
    for i in (0, 1, 4):                     # x, dt and C only
        leaves[i].requires_grad_(True)
    y, S = ssd_chunk(*leaves, chunk=8)
    y0, S0 = ssd_chunk_plain(*map(_t, args), chunk=8)
    assert torch.equal(y.detach(), y0) and torch.equal(S.detach(), S0)
    got = torch.autograd.grad((y, S), [leaves[i] for i in (0, 1, 4)],
                              (_t(dy), _t(dS)))
    want = _plain_grads(args, dy, dS, 8)
    for g, i in zip(got, (0, 1, 4)):
        assert torch.equal(g, want[i])
    with pytest.raises(ValueError, match="state_out"):
        ssd_chunk(*leaves, chunk=8, state_out=torch.zeros(2, 2, 4, 8))
    with torch.no_grad():
        y, _ = ssd_chunk(*leaves, chunk=8)
    assert y.grad_fn is None and torch.equal(y, y0)
    assert ssd_mod.ssd_chunk.backward_launches == before
