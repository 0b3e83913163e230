"""The tiled form (``repro_torch.hwloop.tiled``), which the emulated
accelerator and the simulated backend run on a GPU, against the reference's
tile loop on the same inputs: ``repro.hwloop.EmulatedAccelerator.matmul``
and ``repro.backend.SimulatedBackend``, both numpy, on CPU tensors.

The tiled form is called through its own entry points
(``EmulatedAccelerator._matmul_tiled``, ``SimulatedBackend._execute_tiled``),
not through a switch.  Tolerances:

* every count, flag and ledger total: equal;
* products: within ``1e-12 x max|C|`` (float64 sums in another order), and
  bit-equal on integer-valued operands under a model whose outputs stay
  integers (not ``bitflip``: its flipped bit 40 turns a zero sum into a
  subnormal, which an integer added before or after it keeps or loses);
* ``rel_error``: within ``1e-9`` relative where the loop's value comes from
  a silent tile.  Where no tile is silent the emulated loop reports 0.0 and
  so does the tiled form; the simulated loop reports, for each clean tile,
  the rounding gap between its two summation orders of one exact product
  (``cumsum`` against ``a @ w``, below ``1e-15``), which the tiled form does
  not reproduce: it reports 0.0 there (exact on integer-valued operands,
  where both are 0.0).
"""

import copy

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.flow as jflow
import repro.hwloop as jhw
from repro import backend as jbackend
from repro.core import razor as jrazor
from repro_torch.backend import SimulatedBackend
from repro_torch.core import RazorConfig, SystolicSim, TimingModel
from repro_torch.flow import FlowConfig, run
from repro_torch.hwloop import EmulatedAccelerator, tiled

CFG_KW = dict(array_n=8, tech="vtr-22nm", max_trials=8, seed=2021)
CFG = FlowConfig(**CFG_KW)
JCFG = jflow.FlowConfig(**CFG_KW)
#: (M, K, N): ragged K and N, aligned, and N narrower than the array
SHAPES = ((7, 40, 20), (5, 13, 9), (4, 64, 16), (6, 17, 3))
LEVELS = ("nominal", "detect", "deep")
KINDS = ("real64", "int64", "f32", "bf16T")
RULES = ("emulated-stale", "emulated-tedrop", "emulated-bitflip", "simulated")


@pytest.fixture(scope="module")
def report():
    return run(CFG)


@pytest.fixture(scope="module")
def jreport():
    return jflow.run(JCFG)


def _jtiming():
    return jcore.TimingModel(n=8, clock_ns=JCFG.clock_ns, tech=JCFG.node,
                             seed=JCFG.seed)


def _rail(level, timing):
    if level == "nominal":
        return CFG.node.v_nom
    if level == "detect":       # just below the safe point: DETECTED
        return float(timing.min_safe_voltage().max()) - 0.02
    return 0.58                 # deep in the crash region: SILENT


def _operands(kind, shape, seed):
    """(a, w) tensors and the float64 host arrays the loop gets."""
    m, k, n = shape
    gen = np.random.default_rng(seed)
    a, w = gen.normal(size=(m, k)), gen.normal(size=(k, n))
    if kind == "int64":
        a, w = np.round(3 * a), np.round(3 * w)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    if kind == "f32":
        ta, tw = ta.float(), tw.float()
    elif kind == "bf16T":       # bf16, the weight a transposed view
        ta = ta.to(torch.bfloat16)
        tw = torch.from_numpy(w.T.copy()).to(torch.bfloat16).T
        assert not tw.is_contiguous()
    return ta, tw, ta.double().numpy(), tw.double().numpy()


def _same_product(c, c_ref, exact):
    c_ref = torch.as_tensor(c_ref)
    if exact:
        assert torch.equal(c, c_ref)
    else:
        err = float((c - c_ref).abs().max())
        assert err <= 1e-12 * float(c_ref.abs().max()), err


def _terms_chunk(monkeypatch, chunk):
    """``chunk=1``: one silent K-tile a term tensor (less than any silent
    band here); ``None``: the default budget."""
    monkeypatch.undo()
    if chunk == 1:
        monkeypatch.setattr(tiled, "TERMS_CHUNK_BYTES", 1)


def _same_rel(rel, rel_ref, simulated):
    if simulated and rel_ref < 1e-12:
        assert rel == 0.0 and rel_ref < 1e-15, (rel, rel_ref)
    else:
        assert abs(rel - rel_ref) <= 1e-9 * rel_ref, (rel, rel_ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rule", RULES)
def test_tiled_form_equals_the_loop(report, jreport, rule, shape, level, kind,
                                    monkeypatch):
    ta, tw, a, w = _operands(kind, shape, sum(shape) + len(level))
    if rule == "simulated":
        tm = TimingModel(n=8, clock_ns=CFG.clock_ns, tech=CFG.node,
                         seed=CFG.seed)
        rails = [_rail(level, tm)] * 4
        jbe = jbackend.SimulatedBackend(jcore.SystolicSim(
            _jtiming(), jreport.floorplan.with_voltages(rails),
            jcore.RazorConfig(clock_ns=JCFG.clock_ns)))
        c_ref, t_ref = jbe._execute(a, w)
        be = SimulatedBackend(SystolicSim(tm, report.floorplan.with_voltages(
            rails), RazorConfig(clock_ns=CFG.clock_ns)), device="cpu")
        for chunk in (None, 1):         # 1: one K-tile a term tensor
            _terms_chunk(monkeypatch, chunk)
            c, t = be._execute_tiled(ta, tw)
            got, want = t.to_dict(), t_ref.to_dict()
            _same_rel(got.pop("rel_error"), want.pop("rel_error"), True)
            assert got == want
            _same_product(c, c_ref, kind == "int64")
        return
    corruption = rule.split("-")[1]
    acc = EmulatedAccelerator.from_flow(report, CFG, device="cpu",
                                        corruption=corruption)
    rails = np.full(acc.n_partitions, _rail(level, acc.timing))
    acc.set_rails(rails)
    for chunk in (None, 1):
        jacc = jhw.EmulatedAccelerator.from_flow(jreport, JCFG, rails=rails,
                                                 corruption=corruption)
        tiles = copy.deepcopy(acc)
        _terms_chunk(monkeypatch, chunk)
        c_ref, t_ref = jacc.matmul(a, w)
        c, t = tiles._matmul_tiled(ta, tw)
        for f in ("detected_p", "silent_p", "macs_p", "partition_flags"):
            assert np.array_equal(getattr(t, f), getattr(t_ref, f)), f
        assert (t.replay_cycles, t.cycles) == (t_ref.replay_cycles,
                                               t_ref.cycles)
        assert tiles.ledger.summary() == jacc.ledger.summary()
        _same_rel(t.rel_error, t_ref.rel_error, False)
        _same_product(c, c_ref,
                      kind == "int64" and rule != "emulated-bitflip")
    if level == "deep":
        assert t.silent_p.sum() > 0 and t.rel_error > 0
    if level == "nominal":
        assert t.detected_p.sum() == 0 and t.rel_error == 0.0


@pytest.mark.parametrize("rule", tiled.RULES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_classification_equals_the_loops(report, rule, shape):
    """The status tensor, K-tile by K-tile, against the reference's numpy
    functions on each tile as its loop calls them (the simulator on the
    zero-padded tile, the emulator on the tile's own rows), at the
    reference timing model's delays."""
    acc = EmulatedAccelerator.from_flow(report, CFG, device="cpu")
    acc.set_rails(np.full(acc.n_partitions, _rail("detect", acc.timing)))
    ta, _, a, _ = _operands("real64", shape, 3)
    n = 8
    blocks, late, lost = tiled.classify(ta, acc.delays(ta.device),
                                        acc.razor, acc.quant_bits, n, rule)
    status = torch.where(lost, 2, late.to(torch.int64))
    delays = _jtiming().delays_at(acc.v_map)
    for kt, ki in enumerate(range(0, a.shape[1], n)):
        blk = a[:, ki:ki + n]
        kb = blk.shape[1]
        if rule == "simulated":
            blk = np.pad(blk, ((0, 0), (0, n - kb)))
        rows = blk.shape[1]
        razor = jrazor.RazorConfig(clock_ns=JCFG.clock_ns)
        arrival = jrazor.effective_arrival(
            delays[None, :rows, :], jrazor.streamed_activity(blk)[:, :, None],
            razor)
        want = jrazor.classify_arrival(arrival, razor)
        got = status[kt].numpy()
        assert np.array_equal(got[:, :rows], want), kt
        assert not got[:, rows:].any()
        assert np.array_equal(blocks[kt, :, :kb].numpy(), a[:, ki:ki + n])


def test_weight_column_chunks(report, jreport, monkeypatch):
    """A weight split into several column chunks (as the logits GEMM is at
    full width) gives the one-chunk results, and the reference's."""
    assert tiled.column_chunks(3072, 200192, 8)[0] == (0, 21840)
    assert all((c1 - c0) % 8 == 0 for c0, c1 in
               tiled.column_chunks(3072, 200192, 8)[:-1])
    acc = EmulatedAccelerator.from_flow(report, CFG, device="cpu")
    ta, tw, a, w = _operands("real64", (5, 24, 44), 9)
    for level in ("nominal", "deep"):
        acc.set_rails(np.full(acc.n_partitions, _rail(level, acc.timing)))
        one = copy.deepcopy(acc)._matmul_tiled(ta, tw)
        monkeypatch.setattr(tiled, "WEIGHT_CHUNK_BYTES", 8 * 24 * 16)
        assert len(tiled.column_chunks(24, 44, 8)) == 3
        many = copy.deepcopy(acc)._matmul_tiled(ta, tw)
        monkeypatch.undo()
        assert torch.equal(one[0], many[0]) or level == "deep"
        _same_product(many[0], one[0].numpy(), False)
        assert one[1].rel_error == pytest.approx(many[1].rel_error,
                                                 rel=1e-9)
        c_ref, t_ref = jhw.EmulatedAccelerator.from_flow(
            jreport, JCFG, rails=acc.rails).matmul(a, w)
        _same_product(many[0], c_ref, False)
        _same_rel(many[1].rel_error, t_ref.rel_error, False)
        assert np.array_equal(many[1].silent_p, t_ref.silent_p)


def test_closed_forms_equal_the_loops_sums():
    part = np.random.default_rng(0).integers(0, 4, (8, 8))
    for m, k, n_dim in ((3, 8, 8), (5, 13, 9), (2, 40, 3), (1, 1, 1)):
        macs = np.zeros(4, np.int64)
        cycles = 0
        for ki in range(0, k, 8):
            kb = min(8, k - ki)
            for nj in range(0, n_dim, 8):
                nb = min(8, n_dim - nj)
                macs += m * np.bincount(part[:kb, :nb].reshape(-1),
                                        minlength=4)
                cycles += m + kb + nb - 1
        assert np.array_equal(tiled.emulated_macs(m, k, n_dim, part, 4), macs)
        assert tiled.emulated_cycles(m, k, n_dim, 8) == cycles


@pytest.mark.parametrize("n_bits", [8, 12, 16])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e5, 1e-300])
def test_razor_torch_forms_equal_numpy(n_bits, scale):
    """``streamed_activity_torch`` over a batch of blocks (one all zero, one
    of negative zeros), then ``effective_arrival_torch`` and
    ``classify_arrival_torch``: bit for bit the reference's numpy functions
    on each block."""
    from repro_torch.core import razor as R
    gen = np.random.default_rng(int(n_bits + np.log10(scale) * 7) % 1000)
    a = gen.normal(size=(4, 7, 8)) * scale
    a[1] = 0.0
    a[2] = -0.0
    d = gen.uniform(5.0, 12.0, size=(8, 8))
    act = R.streamed_activity_torch(torch.from_numpy(a), n_bits).numpy()
    for b in range(4):
        want = jrazor.streamed_activity(a[b], n_bits)
        assert np.array_equal(act[b], want), b
        for t_del in (2.5, 0.0):
            cfg = RazorConfig(t_del_ns=t_del)
            jcfg = jrazor.RazorConfig(t_del_ns=t_del)
            arr = jrazor.effective_arrival(d[None], want[:, :, None], jcfg)
            arr_t = R.effective_arrival_torch(
                torch.from_numpy(d)[None], torch.from_numpy(want)[:, :, None],
                cfg)
            assert np.array_equal(arr_t.numpy(), arr)
            assert np.array_equal(
                R.classify_arrival_torch(arr_t, cfg).numpy(),
                jrazor.classify_arrival(arr, jcfg))


def test_tiled_form_refuses_what_it_cannot_count():
    from repro_torch.core import razor as R
    with pytest.raises(ValueError, match="16 bits"):
        R.streamed_activity_torch(torch.zeros(1, 2, 8), 17)
    with pytest.raises(ValueError, match="t_del_ns"):
        tiled.classify(torch.zeros(2, 8, dtype=torch.float64),
                       torch.ones(8, 8, dtype=torch.float64),
                       RazorConfig(t_del_ns=-1.0), 16, 8, "emulated")
    with pytest.raises(ValueError, match="tiling rule"):
        tiled.classify(torch.zeros(2, 8, dtype=torch.float64),
                       torch.ones(8, 8, dtype=torch.float64),
                       RazorConfig(), 16, 8, "nope")
