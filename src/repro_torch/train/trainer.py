"""Training loop: step builder + data pipeline + checkpointing + fault
tolerance.  Counterpart of ``repro.train.trainer``.

The loop is deliberately restart-oriented: all state lives in
(params, opt_state, step); the data pipeline is stateless in `step`; a crash
at any point resumes from the last checkpoint with the same numbers
(tested).

A step is one differentiable ``ModelAPI.train_loss`` (every GEMM through the
active backend: under ``reference`` the ``systolic_mac`` kernel on a GPU,
with straight-through gradients), ``torch.autograd.grad`` over the
parameter leaves, and :func:`repro_torch.optim.apply_updates` in place.  The
gradients are dropped when the step returns, so the device holds the
parameters, the optimizer state and one step's activations and gradients
at a time.  Every family trains; the ssm and hybrid families' recurrences
take their gradients from the backward kernels of ``wkv6`` and
``ssd_chunk`` (with ``cfg.ssm_bf16=True``, ``wkv6``'s bf16 variant).

With mesh ``rules`` (``repro_torch.launch.mesh``) parameters and optimizer
state are ``DTensor`` s laid out by their logical axes, each rank updates
its shards, and checkpoints hold the gathered leaves.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import optim
from .._device import DeviceLike, resolve_device
from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig, ShapeConfig
from ..data.pipeline import DataConfig, PrefetchLoader, SyntheticDataset
from ..models import model_api
from ..models.api import BatchSpec, ModelAPI
from ..models.shardlib import (Rules, distribute_tree, is_dtensor,
                               tree_leaves, tree_map, use_rules)
from ..runtime.monitor import HeartbeatMonitor

Pytree = Any


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    async_checkpoint: bool = True
    seed: int = 0


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    steps_done: int
    final_params: Pytree
    final_opt_state: Pytree
    wall_s: float


def check_rules(rules: Any) -> None:
    """``rules`` is None (one device holds every tensor whole: the
    reference's replicated rules) or a :class:`Rules`."""
    if rules is not None and not isinstance(rules, Rules):
        raise TypeError(f"rules must be a repro_torch.models.shardlib.Rules "
                        f"or None, not {type(rules).__name__}")


def _on_mesh(rules: Optional[Rules]) -> bool:
    return rules is not None and rules.mesh is not None


def distribute_batch(batch: Dict[str, torch.Tensor],
                     rules: Optional[Rules]) -> Dict[str, torch.Tensor]:
    """Every batch input split over its leading (batch) axis on the rules'
    mesh (``BatchSpec``'s layout: ``("batch", None, ...)``); plain tensors
    without a mesh, and a ``DTensor`` as it is."""
    if not _on_mesh(rules):
        return batch
    out = {}
    for k, v in batch.items():
        if is_dtensor(v):
            out[k] = v
            continue
        spec = BatchSpec(tuple(v.shape), v.dtype,
                         ("batch",) + (None,) * (v.dim() - 1))
        out[k] = distribute_tree(v, spec, rules)
    return out


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A replicated ``DTensor`` as the plain tensor every rank holds."""
    return x.full_tensor() if is_dtensor(x) else x


def make_train_step(api: ModelAPI, cfg: ModelConfig,
                    opt_cfg: optim.AdamWConfig, rules: Any = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``.  The update is written into ``params`` and ``opt_state`` in
    place, the trees returned are the ones given (the reference's
    ``donate=True``; there is no copying form), and ``loss`` is a detached
    0-d tensor.  With mesh ``rules`` the step runs under them
    (:func:`~repro_torch.models.shardlib.use_rules`) on ``DTensor``
    parameters and state (:func:`~repro_torch.models.shardlib.
    distribute_tree`); a plain batch is split over its batch axis first."""
    check_rules(rules)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        with use_rules(rules):
            batch = distribute_batch(batch, rules)
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss = api.train_loss(params, batch)
                grads = iter(torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))
            grad_tree = tree_map(lambda _: next(grads), params)
            optim.apply_updates(params, opt_state, grad_tree, opt_cfg)
        return params, opt_state, _whole(loss.detach())

    return train_step


def _batch_on(batch_np, cfg: ModelConfig, shape: ShapeConfig,
              device: torch.device):
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_np.data.items()}
    if cfg.frontend == "vision":
        # trim text to leave room for the patch prefix
        p = min(cfg.frontend_tokens, shape.seq_len // 2)
        batch["patch_embeds"] = batch["patch_embeds"][:, :p].to(
            torch.bfloat16)
        batch["tokens"] = batch["tokens"][:, :shape.seq_len - p]
        batch["labels"] = batch["labels"][:, :shape.seq_len - p]
    return batch


def train(cfg: ModelConfig, shape: ShapeConfig,
          train_cfg: Optional[TrainConfig] = None,
          opt_cfg: Optional[optim.AdamWConfig] = None,
          rules: Any = None,
          monitor: Optional[HeartbeatMonitor] = None,
          resume: bool = False,
          device: DeviceLike = None,
          init: Optional[Callable[[ModelAPI], Pytree]] = None
          ) -> TrainResult:
    """The reference's loop on ``device`` (``None``: the GPU).  ``init``
    makes the first parameters from the model's API (default:
    ``api.init_params(train_cfg.seed)``); the tests pass the reference's
    own weights through it."""
    train_cfg = train_cfg or TrainConfig()
    opt_cfg = opt_cfg or optim.AdamWConfig(total_steps=train_cfg.steps)
    check_rules(rules)
    dev = resolve_device(device)
    api = model_api(cfg, device=dev)

    params = init(api) if init is not None else api.init_params(
        train_cfg.seed)
    opt_state = optim.init_state(params, opt_cfg)
    if _on_mesh(rules):
        # every rank made the same seeded tree; each keeps its shards
        params = distribute_tree(params, api.param_specs(), rules)
        opt_state = distribute_tree(
            opt_state, optim.state_specs(api.param_specs(), opt_cfg), rules)
    start_step = 0

    ckpt = None
    if train_cfg.checkpoint_dir:
        ckpt = CheckpointManager(train_cfg.checkpoint_dir)
        if resume and ckpt.latest_step() is not None:
            # in place: the device holds one copy of the state
            ckpt.restore({"params": params, "opt": opt_state})
            start_step = ckpt.latest_step()

    data_cfg = DataConfig(
        vocab_size=cfg.padded_vocab, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=train_cfg.seed,
        mean_doc_len=max(shape.seq_len // 8, 8),   # learnable unigram signal
        frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model, enc_frames_ratio=cfg.enc_frames_ratio)
    dataset = SyntheticDataset(data_cfg)
    loader = PrefetchLoader(dataset, start_step=start_step)

    step_fn = make_train_step(api, cfg, opt_cfg, rules)

    losses: List[float] = []
    t0 = time.time()
    step = start_step
    try:
        for step in range(start_step, train_cfg.steps):
            batch = _batch_on(next(loader), cfg, shape, dev)
            t_step = time.time()
            params, opt_state, loss = step_fn(params, opt_state, batch)
            loss_f = float(loss)
            losses.append(loss_f)
            if monitor is not None:
                monitor.beat(0, step, time.time() - t_step)
            if not np.isfinite(loss_f):
                raise FloatingPointError(f"loss diverged at step {step}")
            if train_cfg.log_every and step % train_cfg.log_every == 0:
                print(f"step {step:5d} loss {loss_f:.4f} "
                      f"({time.time() - t_step:.2f}s)")
            if (ckpt and train_cfg.checkpoint_every
                    and (step + 1) % train_cfg.checkpoint_every == 0):
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          blocking=not train_cfg.async_checkpoint)
    finally:
        loader.close()
        if ckpt:
            ckpt.wait()

    return TrainResult(losses=losses, steps_done=step + 1 - start_step,
                       final_params=params, final_opt_state=opt_state,
                       wall_s=time.time() - t0)
