"""Step builders: train / prefill / decode / forward functions for an
(arch x shape) cell on one device.  Counterpart of ``repro.launch.steps``
on its replicated rules (one device holds every tensor whole).

The reference jits each step with full in/out shardings and can lower it
abstractly for any mesh.  The port's steps run eagerly: ``BuiltStep.fn`` is
the plain callable and ``arg_structs`` holds ``meta`` tensors of the
arguments' shapes and dtypes.  Lowering without data (``BuiltStep.lower``)
and choosing rules from a mesh (``build_cell``) need XLA or a device mesh,
which arrive with ROADMAP A14: both raise, naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .. import optim
from .._device import DeviceLike
from ..configs.base import ModelConfig, ShapeConfig
from ..models import model_api
from ..models.api import BatchSpec, ModelAPI
from ..models.shardlib import tree_map
from ..train.trainer import check_rules, make_train_step

Pytree = Any

_NEEDS_MESH = ("needs XLA or a device mesh, which is not ported yet "
               "(ROADMAP.md queue A, A14)")


def _structs(specs: Pytree) -> Pytree:
    """``meta`` tensors of a spec tree's shapes and dtypes."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def _batch_structs(batch_specs: Dict[str, BatchSpec]):
    return {k: v.struct() for k, v in batch_specs.items()}


@dataclasses.dataclass
class BuiltStep:
    """A step callable plus stand-ins of its arguments."""

    fn: Any                      # the step callable
    arg_structs: Tuple[Pytree, ...]
    kind: str                    # train | prefill | decode
    cfg: ModelConfig
    api: ModelAPI
    rules: Any = None            # None: one device holds everything

    def lower(self):
        raise NotImplementedError(f"lowering a step without data "
                                  f"{_NEEDS_MESH}")


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, rules: Any = None,
                     opt_cfg: Optional[optim.AdamWConfig] = None,
                     device: DeviceLike = None) -> BuiltStep:
    check_rules(rules)
    api = model_api(cfg, device=device)
    opt_cfg = opt_cfg or optim.AdamWConfig()
    pspecs = api.param_specs()
    ospecs = optim.state_specs(pspecs, opt_cfg)
    bspecs = api.input_specs(shape)
    fn = make_train_step(api, cfg, opt_cfg, rules)
    args = (_structs(pspecs), _structs(ospecs), _batch_structs(bspecs))
    return BuiltStep(fn, args, "train", cfg, api, rules)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       rules: Any = None,
                       device: DeviceLike = None) -> BuiltStep:
    check_rules(rules)
    api = model_api(cfg, device=device)
    pspecs = api.param_specs()
    bspecs = api.input_specs(shape)

    def prefill_step(params, batch):
        return api.prefill(params, batch, max_len=shape.seq_len)

    args = (_structs(pspecs), _batch_structs(bspecs))
    return BuiltStep(prefill_step, args, "prefill", cfg, api, rules)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      rules: Any = None,
                      device: DeviceLike = None) -> BuiltStep:
    """The decode step writes its state in place (the reference's
    ``donate=True``; there is no copying form)."""
    check_rules(rules)
    api = model_api(cfg, device=device)
    pspecs = api.param_specs()
    sspecs = api.decode_state_specs(shape)
    tokens = BatchSpec((shape.global_batch, 1), torch.int32, ("batch", None))
    args = (_structs(pspecs), _structs(sspecs), tokens.struct())
    return BuiltStep(api.decode_step, args, "decode", cfg, api, rules)


def build_cell(arch: str, shape: ShapeConfig, mesh: Any,
               smoke: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               opt_cfg: Optional[optim.AdamWConfig] = None) -> BuiltStep:
    """One (arch x shape) cell on a mesh: picks its rules from the mesh."""
    raise NotImplementedError(f"build_cell({arch!r}, ...) on a mesh "
                              f"{_NEEDS_MESH}")


def build_forward_step(cfg: ModelConfig, shape: ShapeConfig,
                       rules: Any = None,
                       device: DeviceLike = None) -> BuiltStep:
    """Forward-only (no grad) step — SSM/hybrid prefill proxy."""
    check_rules(rules)
    api = model_api(cfg, device=device)
    pspecs = api.param_specs()
    train_like = ShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                             "train")
    bspecs = api.input_specs(train_like)
    args = (_structs(pspecs), _batch_structs(bspecs))
    return BuiltStep(api.loss, args, "prefill", cfg, api, rules)
