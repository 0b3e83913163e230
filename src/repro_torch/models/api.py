"""Family dispatch: one uniform interface over every architecture family.

    api = model_api(cfg, device="cpu")
    api.param_specs() / api.init_params(seed)
    api.prefill(params, batch) -> (logits, state)
    api.decode_step(params, state, tokens) -> (logits, state)
    api.decode_state_specs(shape) -> decode-state ParamSpecs
    api.make_decode_state(shape) -> all-zeros decode state
    api.slot_slice / slot_update / slot_reset -> per-slot state surgery
        (continuous batching: one batch row is admitted/evicted without
        recomputing the rest of the batch)

Counterpart of ``repro.models.api``.  The dense family is ported; the other
families raise ``NotImplementedError`` naming their ROADMAP item.  The
decode state is updated **in place**: ``decode_step``, ``slot_update`` and
``slot_reset`` write into the tensors they are given and return that tree.
Steps and state surgery run under ``torch.inference_mode()``; a decode state
is made by ``make_decode_state`` / ``prefill`` and only ever handed back to
these methods.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig, ShapeConfig
from . import lm
from .shardlib import init_param_tree, tree_map

Params = Dict[str, Any]

_ROADMAP_ITEM = {
    "moe": "queue A: MoE and VLM configs",
    "vlm": "queue A: MoE and VLM configs",
    "ssm": "queue A/B: models/ssm.py with kernels B4 wkv6 and B5 ssd_chunk",
    "hybrid": "queue A/B: models/ssm.py with kernels B4 wkv6 and B5 "
              "ssd_chunk",
    "encdec": "queue A: models/encdec.py",
}


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    #: Execution backend for the model's dense GEMMs (a
    #: ``repro_torch.backend`` name or instance); ``None`` keeps the
    #: surrounding scope's backend (usually the plain ``torch.matmul`` path).
    backend: Any = None
    #: Where parameters and decode states are made; ``None`` means the GPU.
    device: DeviceLike = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.family} family is not "
                f"ported yet (ROADMAP.md "
                f"{_ROADMAP_ITEM.get(self.cfg.family, 'queue A')})")
        if self.backend is not None:
            # resolve a name to ONE instance up front: per-call resolution
            # would strand its telemetry
            from ..backend import MatmulBackend, get_backend
            if not isinstance(self.backend, MatmulBackend):
                self.backend = get_backend(self.backend, device=self.device)

    def _scope(self):
        """Active-backend scope for model steps."""
        if self.backend is None:
            return contextlib.nullcontext()
        from ..backend import use_backend
        return use_backend(self.backend)

    # ---- params --------------------------------------------------------------

    def param_specs(self) -> Params:
        return lm.param_specs(self.cfg)

    def init_params(self, seed: int = 0,
                    device: DeviceLike = None) -> Params:
        """Random parameters from ``seed``: a ``torch.Generator`` on the
        device, normal draws scaled ``1/sqrt(fan_in)`` (0.02 for the
        embedding), bf16 weights and f32 norm scales.  The numbers are not
        ``jax.random``'s for the same seed."""
        dev = self.device if device is None else resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return init_param_tree(gen, self.param_specs(), dev)

    # ---- steps ---------------------------------------------------------------

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        with self._scope(), torch.inference_mode():
            return lm.prefill(params, batch, self.cfg, max_len)

    def decode_step(self, params: Params, state: Params,
                    tokens: torch.Tensor):
        with self._scope(), torch.inference_mode():
            return lm.decode_step(params, state, tokens, self.cfg)

    # ---- specs ---------------------------------------------------------------

    def decode_state_specs(self, shape: ShapeConfig) -> Params:
        b, s = shape.global_batch, shape.seq_len
        return lm.decode_state_specs(self.cfg, b, s,
                                     long_context=shape.name == "long_500k")

    # ---- per-slot state surgery (continuous batching) ------------------------
    #
    # Every decode-state leaf carries its logical axes in the spec tree, so the
    # batch ("slot") axis can be located per leaf and one row read or written
    # — no per-family knowledge, no batch recompute.

    def make_decode_state(self, shape: ShapeConfig) -> Params:
        """All-zeros decode state matching ``decode_state_specs(shape)``."""
        with torch.inference_mode():
            return tree_map(
                lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                      device=self.device),
                self.decode_state_specs(shape))

    def slot_slice(self, shape: ShapeConfig, state: Params,
                   slot: int) -> Params:
        """Extract batch row ``slot`` of a decode state as a batch-1 state
        (a copy: later in-place steps do not reach it)."""
        def take(spec, leaf):
            if "batch" not in spec.logical:
                return leaf
            ax = spec.logical.index("batch")
            return leaf.narrow(ax, int(slot), 1).clone()
        with torch.inference_mode():
            return tree_map(take, self.decode_state_specs(shape), state)

    def slot_update(self, shape: ShapeConfig, state: Params, slot: int,
                    sub: Params) -> Params:
        """Write a batch-1 sub-state (e.g. a fresh prefill) into row
        ``slot`` in place; every other slot's state is untouched.  Returns
        ``state``."""
        def put(spec, leaf, s):
            if "batch" in spec.logical:
                ax = spec.logical.index("batch")
                leaf.narrow(ax, int(slot), 1).copy_(s)
        with torch.inference_mode():
            tree_map(put, self.decode_state_specs(shape), state, sub)
        return state

    def slot_reset(self, shape: ShapeConfig, state: Params,
                   slot: int) -> Params:
        """Zero one slot's state (eviction) in place.  Returns ``state``."""
        def zero(spec, leaf):
            if "batch" in spec.logical:
                ax = spec.logical.index("batch")
                leaf.narrow(ax, int(slot), 1).zero_()
        with torch.inference_mode():
            tree_map(zero, self.decode_state_specs(shape), state)
        return state


def model_api(cfg: ModelConfig, backend: Any = None,
              device: DeviceLike = None) -> ModelAPI:
    return ModelAPI(cfg, backend=backend, device=device)
