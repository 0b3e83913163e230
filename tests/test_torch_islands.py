"""The precision-island loop (``repro_torch.examples.precision_islands``)
against the same four stages built from ``repro.flow`` and the
``repro.kernels.ref`` oracles, on the same numpy-made operands.

The stages are those of ``examples/precision_islands.py`` (headroom, static
tiers, Razor-driven ``PrecisionController.calibrate``, execute + energy
report), with the JAX oracles in place of the Pallas kernels.  Headroom,
static tiers, Razor flags, calibrated tiers and both energy ratios must be
equal; ``rel_error`` within 1e-6 (the two stacks take the exact product and
its norm in another order).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import (PrecisionController, energy_ratio,
                                  static_tier_assignment, tile_headroom)
from repro.flow import Artifacts, FunctionStage, Pipeline
from repro.kernels import ref as jref
from repro_torch.examples import precision_islands as islands
from repro_torch.kernels.ops import precision_mm, razor_mm


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[0, 128:] *= 40.0                     # the example's outlier recipe
    return ((jnp.asarray(a).astype(jnp.bfloat16),
             jnp.asarray(w).astype(jnp.bfloat16)),
            (torch.from_numpy(a).to(torch.bfloat16),
             torch.from_numpy(w).to(torch.bfloat16)))


def _reference_pipeline(m, n):
    """examples/precision_islands.py's four stages on the jnp oracles."""

    def extract_headroom(art, cfg):
        head = tile_headroom(np.asarray(art.weights, np.float32),
                             tile=cfg.block)
        return art.with_(headroom=head)

    def assign_static_tiers(art, cfg):
        gm, gn = m // cfg.block, n // cfg.block
        tiers = np.zeros((gm, gn), np.int64)
        tiers[:] = static_tier_assignment(
            np.broadcast_to(art.headroom.mean(0), (gm, gn)))
        return art.with_(static_tiers=tiers)

    def calibrate_tiers(art, cfg):
        _, flags, _ = jref.razor_matmul(art.activations, art.weights,
                                        tol=cfg.tol)
        ctrl = PrecisionController()

        def trial(t):
            _, f, _ = jref.razor_matmul(art.activations, art.weights,
                                        tol=cfg.tol)
            need = np.where(np.asarray(f) > 0, 2, 0)
            return t < need

        calibrated = ctrl.calibrate(art.static_tiers, trial)
        return art.with_(razor_flags=np.asarray(flags), tiers=calibrated)

    def execute_and_report(art, cfg):
        c = jref.precision_island(art.activations, art.weights,
                                  jnp.asarray(art.tiers, jnp.int32))
        exact = (np.asarray(art.activations, np.float32)
                 @ np.asarray(art.weights, np.float32))
        err = np.linalg.norm(np.asarray(c) - exact) / np.linalg.norm(exact)
        return art.with_(product=c, rel_error=err,
                         energy_vs_bf16=energy_ratio(art.tiers),
                         static_energy_vs_bf16=energy_ratio(art.static_tiers))

    return Pipeline([
        FunctionStage("headroom", extract_headroom,
                      requires=("weights",), provides=("headroom",)),
        FunctionStage("static_tiers", assign_static_tiers,
                      requires=("headroom",), provides=("static_tiers",)),
        FunctionStage("calibrate", calibrate_tiers,
                      requires=("activations", "weights", "static_tiers"),
                      provides=("razor_flags", "tiers")),
        FunctionStage("execute", execute_and_report,
                      requires=("activations", "weights", "tiers"),
                      provides=("product", "rel_error", "energy_vs_bf16")),
    ])


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (128, 256, 384)])
def test_pipeline_matches_the_reference_stages(m, k, n):
    (ja, jw), (ta, tw) = _operands(m, k, n)
    art = islands.run(ta, tw, block=128, tol=0.02)
    cfg = islands.IslandConfig(block=128, tol=0.02, m=m)
    ref = _reference_pipeline(m, n).run(
        cfg, initial=Artifacts({"activations": ja, "weights": jw}))
    for key in ("headroom", "static_tiers", "razor_flags", "tiers"):
        np.testing.assert_array_equal(np.asarray(art[key]),
                                      np.asarray(ref[key]), err_msg=key)
    assert art.energy_vs_bf16 == ref.energy_vs_bf16
    assert art.static_energy_vs_bf16 == ref.static_energy_vs_bf16
    assert abs(art.rel_error - float(ref.rel_error)) <= 1e-6
    # the outlier columns fire and are calibrated up to the f32 tier, the
    # clean ones settle on the cheapest
    assert art.razor_flags[:, 0].tolist() == [0] * (m // 128)
    assert art.razor_flags[:, 1:].all()
    assert (art.tiers[:, 1:] == 2).all() and (art.tiers[:, 0] == 0).all()
    assert tuple(art.product.shape) == (m, n)
    assert art.product.dtype == torch.float32


def test_pipeline_stages_and_kernel_calls():
    """1 + up to 16 razor_matmul calls (the reference's ``trial`` re-runs
    the product and ignores the tiers it is given), 1 precision_island."""
    calls = {"razor": 0, "precision": 0}

    def razor(a, b, tol):
        calls["razor"] += 1
        return razor_mm(a, b, tol=tol)

    def precision(a, b, tiers):
        calls["precision"] += 1
        return precision_mm(a, b, tiers)

    (_, _), (ta, tw) = _operands(256, 256, 256)
    pipe = islands.build_pipeline(razor, precision)
    assert [s.name for s in pipe.stages] == ["headroom", "static_tiers",
                                             "calibrate", "execute"]
    art = islands.run(ta, tw, razor=razor, precision=precision)
    assert 2 <= calls["razor"] <= 17 and calls["precision"] == 1
    plain = islands.run(ta, tw)
    assert torch.equal(art.product, plain.product)


def test_example_operands_and_cli_output():
    a, w = islands.example_operands(device="cpu")
    (_, _), (ta, tw) = _operands(256, 256, 256)
    assert torch.equal(a, ta) and torch.equal(w, tw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert islands.main(["--device", "cpu"]) == 0
    out = buf.getvalue()
    assert out.startswith("custom pipeline: ['headroom', 'static_tiers', "
                          "'calibrate', 'execute']")
    for line in ("static tiers:", "razor mismatch flags:",
                 "calibrated tiers:", "result rel-error vs f32:",
                 "energy vs all-bf16:"):
        assert line in out
