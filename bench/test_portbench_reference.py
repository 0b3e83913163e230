"""The plain references against the port (``repro_torch``) at its smoke
widths on the CPU: the dense decoder's loss against ``ModelAPI.loss`` on
the reference backend, its logits against a prefill, and the reference
AdamW against ``optim.apply_updates``.  The port rounds its
activations to bf16 and the references do not, so each tolerance is a
bf16-sized one."""

from __future__ import annotations

import dataclasses

import torch

from bench.harness import manifest as mf, traffic as gen, weights
from bench.reference import adamw, dense

CPU = torch.device("cpu")


def _setup(name, seed=7):
    from repro_torch.models import model_api
    cfg = mf.model_config(mf.load_config(name), smoke=True)
    api = model_api(cfg, backend="reference", device=CPU)
    w = weights.make(api.param_specs(), seed, CPU)
    return cfg, api, w


def test_loss_matches_port():
    cfg, api, w = _setup("phi4-mini-3.8b")
    ref = dense
    tokens, labels = gen.batch_rows(5, 0, 2, 64, cfg.vocab_size, CPU)
    port = float(api.loss(w, {"tokens": tokens, "labels": labels}))
    plain = ref.loss(w, dataclasses.asdict(cfg), tokens, labels)
    assert abs(port - plain) / plain < 1e-3
    low = ref.loss(w, dataclasses.asdict(cfg), tokens, labels, "int8")
    assert low != plain


def test_dense_logits_match_prefill():
    cfg, api, w = _setup("phi4-mini-3.8b")
    tokens, _ = gen.batch_rows(5, 1, 1, 24, cfg.vocab_size, CPU)
    port, _ = api.prefill(w, {"tokens": tokens}, max_len=32)
    plain = dense.logits_at(w, dataclasses.asdict(cfg), [tokens[0]],
                            [torch.tensor([23])])[0]
    scale = plain.abs().max()
    assert (port.float() - plain).abs().max() / scale < 2e-2


def test_adamw_matches_port():
    from repro_torch import optim
    g = torch.Generator().manual_seed(4)
    params = {"a": torch.randn(6, 5, generator=g),
              "b": torch.randn(7, generator=g)}
    cfg = optim.AdamWConfig()
    state = optim.init_state(params, cfg)
    mine = [t.clone() for t in params.values()]
    mu = [torch.zeros_like(t) for t in mine]
    nu = [torch.zeros_like(t) for t in mine]
    h = adamw.Hyper()
    for step in range(1, 4):
        grads = {k: torch.randn(t.shape, generator=g) * 3
                 for k, t in params.items()}
        optim.apply_updates(params, state, grads, cfg)
        gl = list(grads.values())
        adamw.update(h, step, mine, gl, mu, nu, adamw.clip_factor(h, gl))
    for k, t in zip(params, mine):
        assert torch.allclose(state["per_param"][k]["master"], t,
                              rtol=1e-5, atol=1e-7)
