"""Each cell's control at the smoke size on the CPU, through the cell's
own check: the plain reference put in the program's place in fp8 (e4m3,
the precision below the configurations' bf16) reads well above what the
program reads on the same requests or batches and, where the cell's
number is a relative one (a loss's, a norm's), comes out not correct at
the cell's committed limits.  A served cell's ``logit_gap`` is in logits
of the full-size model, which a smoke model's small logits never reach.
On the chip ``bench/control.py`` reads the same at the cells' own size,
where the limits are set between the two."""

from __future__ import annotations

import pytest
import torch

from bench import control
from bench.harness import common, manifest as mf
from bench.test_portbench_drivers import seconds

CPU = torch.device("cpu")
CELLS = [w["name"] for w in mf.load_manifest()["workloads"]]
#: how far above the program's reading the control has to read here
SEPARATION = 2.0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught_by_the_check(cell, seed=31):
    ctx = common.build_context(cell, seed, seconds(cell), smoke=True,
                               device=CPU)
    found = control.readings(ctx, ("program", control.CONTROL))
    program, fp8 = found["program"], found[control.CONTROL]
    if ctx.traffic["driver"] != "serve":
        assert not fp8["correct"], fp8
    # the control fails one of the cell's numbers by the separation
    assert any(fp8[k] > SEPARATION * program[k] for k in mf.limits_of(
        mf.load_cell(cell))), (program, fp8)


def test_summary_counts_correct_seeds():
    rows = [{"program": {"gap": 1.0, "correct": True},
             "control.fp8": {"gap": 5.0, "correct": False}},
            {"program": {"gap": 2.0, "correct": True},
             "control.fp8": {"gap": 4.0, "correct": False}}]
    out = control.summary(rows)
    assert out["program"] == {"gap": [1.0, 2.0], "correct_seeds": 2}
    assert out["control.fp8"] == {"gap": [4.0, 5.0], "correct_seeds": 0}
