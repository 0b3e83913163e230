"""Training zamba2-2.7b (the hybrid family) in the port, on the CPU: the
checks of ``tests/test_torch_train_ssm.py`` (which says what each holds and
with which tolerance) on zamba2's smoke config, in a file of their own so
each file runs in about a minute."""

from test_torch_train_ssm import (a_steps_telemetry_on_reference,
                                  entry_points_train, five_steps_on_ideal)

ARCH = "zamba2-2.7b"


def test_five_steps_match_the_references_train_step():
    five_steps_on_ideal(ARCH)


def test_a_steps_gemm_count_equals_the_references():
    a_steps_telemetry_on_reference(ARCH)


def test_entry_points_train(monkeypatch, capsys):
    entry_points_train(ARCH, monkeypatch, capsys)
