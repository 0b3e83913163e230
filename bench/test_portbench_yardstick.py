"""The yardstick's counts against values worked out by hand: one phi4-mini
GEMM and the GEMM counts a step hands B1 (those the port's kernel counters
show on the card); and the counts found by the family's name in its plain
reference."""

from __future__ import annotations

import dataclasses

import pytest

from bench.harness import manifest as mf
from bench.harness.yardstick import (HBM_BYTES_PER_S, PEAK_BF16, Yardstick,
                                     gemm_bound_s)


def _yard(name):
    return Yardstick(dataclasses.asdict(mf.model_config(mf.load_config(name))))


def test_phi4_wq_at_a_train_step():
    # M = 2 x 256 rows, K = N = 3072, bf16 in, f32 out
    m, k, n = 512, 3072, 3072
    nbytes = 2 * (512 * 3072 + 3072 * 3072) + 4 * 512 * 3072
    assert nbytes == 28_311_552
    ops = 2 * 512 * 3072 * 3072
    assert ops == 9_663_676_416
    # 9.77e-6 s by the operations, 8.45e-6 s by the bytes
    assert gemm_bound_s(m, k, n) == pytest.approx(ops / PEAK_BF16)
    assert gemm_bound_s(m, k, n) > nbytes / HBM_BYTES_PER_S
    # a decode row of 64: bound by the weight's bytes
    assert gemm_bound_s(64, k, n) == pytest.approx(
        (2 * (64 * 3072 + 3072 * 3072) + 4 * 64 * 3072) / HBM_BYTES_PER_S)


def test_phi4_counts():
    y = _yard("phi4-mini-3.8b")
    # per layer: wq 3072^2, wk/wv 3072 x 1024, wo 3072^2, wg/w1/w2 3072 x 8192
    per_layer = 2 * 3072 * 3072 + 2 * 3072 * 1024 + 3 * 3072 * 8192
    assert per_layer == 100_663_296
    assert y.gemm_flops_per_row() == 2.0 * 32 * per_layer
    assert y.logits_flops_per_row() == 2.0 * 3072 * 200_192
    assert len(y.b1_calls(("decode", 64))) == 7 * 32 + 1
    assert len(y.b1_calls(("train", 2, 256))) == 13 * 32 + 1     # 417
    # the loss at 4 x 2048: 8 cross-entropy chunks of 4 x 256 rows
    calls = y.b1_calls(("loss", 4, 2048))
    assert len(calls) == 7 * 32 + 8
    assert calls[-1] == (1024, 3072, 200_192)
    # attention of a 2048-token row: 2048 * 2049 / 2 causal pairs of
    # 4 * 24 * 128 FLOPs a layer
    assert y.forward_flops(1, 2048) == pytest.approx(
        2048 * (2.0 * 32 * per_layer + 2.0 * 3072 * 200_192)
        + 2048 * 2049 / 2 * 4 * 24 * 128 * 32)
    assert y.train_flops(2, 256) == 3 * y.forward_flops(2, 256)


@pytest.mark.parametrize("call,expect", [
    (("decode", 64), 7 * 32 + 1),
    (("prefill", 1019), 7 * 32 + 1),
    (("loss", 4, 2048), 7 * 32 + 8),
    (("train", 2, 256), 13 * 32 + 1),
])
def test_b1_calls_of_each_model_call(call, expect):
    y = _yard("phi4-mini-3.8b")
    calls = y.b1_calls(call)
    assert len(calls) == expect
    rows = call[1] * (call[2] if len(call) == 3 else 1)
    assert calls[0] == (rows, 3072, 3072)
    assert y.b1_bound_s([call]) == pytest.approx(
        sum(gemm_bound_s(*g) for g in calls))


def test_counts_come_from_the_family_reference(monkeypatch):
    """A family's counts are its reference's ``counts()``: a family with
    no reference file has none, and one whose file brings extra per-token
    FLOPs gets them in its model FLOPs."""
    conf = dataclasses.asdict(mf.model_config(mf.load_config(
        "phi4-mini-3.8b")))
    with pytest.raises(FileNotFoundError):
        Yardstick({**conf, "family": "nofamily"})
    plain = Yardstick(conf)
    dense = mf.load_module("reference", "dense")

    class Extra:
        @staticmethod
        def counts(c):
            return {**dense.counts(c), "row_flops": lambda seq: 1e6}
    monkeypatch.setattr(mf, "load_module", lambda kind, name: Extra)
    extra = Yardstick(conf)
    assert extra.gemms == plain.gemms
    assert extra.forward_flops(2, 64) == pytest.approx(
        plain.forward_flops(2, 64) + 2 * 64 * 1e6)
