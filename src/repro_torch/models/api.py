"""Family dispatch: one uniform interface over every architecture family.

    api = model_api(cfg, device="cpu")
    api.param_specs() / api.init_params(seed)
    api.loss(params, batch) -> mean cross-entropy (a forward pass)
    api.train_loss(params, batch) -> the same loss, differentiable
    api.prefill(params, batch) -> (logits, state)
    api.decode_step(params, state, tokens) -> (logits, state)
    api.input_specs(shape) -> batch of BatchSpecs (meta tensors + logical axes)
    api.decode_state_specs(shape) -> decode-state ParamSpecs
    api.make_decode_state(shape) -> all-zeros decode state
    api.slot_slice / slot_update / slot_reset -> per-slot state surgery
        (continuous batching: one batch row is admitted/evicted without
        recomputing the rest of the batch)

Counterpart of ``repro.models.api``, for every family (dense, moe, vlm,
ssm, hybrid, encdec).  As in the JAX package, ssm/hybrid prompts are absorbed
by ``decode_step`` (``prefill`` raises).  The
decode state is updated **in place**: ``decode_step``, ``slot_update`` and
``slot_reset`` write into the tensors they are given and return that tree.
Serving steps, ``loss`` and state surgery run under
``torch.inference_mode()`` (``torch.no_grad()`` under mesh rules); a decode
state is made by ``make_decode_state`` / ``prefill`` and only ever handed
back to these methods.  ``train_loss`` runs
with autograd recording (the trainer's loss): every family, ssm and hybrid
through the backward kernels of their recurrences (``wkv6`` and
``ssd_chunk``; with ``cfg.ssm_bf16=True`` rwkv6's bf16 recurrence through
``wkv6``'s bf16 backward).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig, ShapeConfig
from . import encdec, lm, ssm
from .shardlib import current_rules, init_param_tree, tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Shape, dtype and logical axes of one batch input."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Tuple[Optional[str], ...]

    def struct(self) -> torch.Tensor:
        """A stand-in with this shape and dtype that holds no data (a
        ``meta`` tensor; the reference's ``ShapeDtypeStruct``)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def _no_grad():
    """``torch.inference_mode()``; ``torch.no_grad()`` where the active
    rules carry a mesh (a ``DTensor`` view cannot be made in inference
    mode)."""
    if current_rules().mesh is not None:
        return torch.no_grad()
    return torch.inference_mode()


def _token_batch(b: int, s: int, with_labels: bool) -> Dict[str, BatchSpec]:
    out = {"tokens": BatchSpec((b, s), torch.int32, ("batch", None))}
    if with_labels:
        out["labels"] = BatchSpec((b, s), torch.int32, ("batch", None))
    return out


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
        f = self.cfg.family
        if f in ("dense", "moe", "vlm"):
            return lm.param_specs(self.cfg)
        if f == "ssm":
            return ssm.rwkv6_param_tree(self.cfg)
        if f == "hybrid":
            return ssm.zamba2_param_tree(self.cfg)
        if f == "encdec":
            return encdec.param_specs(self.cfg)
        raise ValueError(f"unknown family {f}")

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

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (with ``patch_embeds`` in front for vlm, and
        ``frames`` to attend to for encdec): a forward pass, no gradient
        (:meth:`train_loss` is the differentiable one)."""
        f = self.cfg.family
        with self._scope(), _no_grad():
            if f == "ssm":
                return ssm.rwkv6_loss(params, batch, self.cfg)
            if f == "hybrid":
                return ssm.zamba2_loss(params, batch, self.cfg)
            if f == "encdec":
                return encdec.loss_fn(params, batch, self.cfg)
            return lm.loss_fn(params, batch, self.cfg)

    def train_loss(self, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """:meth:`loss` with autograd recording: the same family dispatch in
        the same backend scope, each block under ``cfg.remat``.  A routed
        GEMM's gradient is the straight-through one (exact products; the
        backend's ``traced_matmul``); the recurrences' gradients are their
        backward kernels' (``wkv6``, ``ssd_chunk``)."""
        f = self.cfg.family
        with self._scope():
            if f == "ssm":
                return ssm.rwkv6_loss(params, batch, self.cfg)
            if f == "hybrid":
                return ssm.zamba2_loss(params, batch, self.cfg)
            if f == "encdec":
                return encdec.loss_fn(params, batch, self.cfg)
            return lm.loss_fn(params, batch, self.cfg)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        f = self.cfg.family
        if f in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"prefill for {f}: SSM/hybrid prompts are absorbed by "
                "running decode_step over the prompt (O(1) state)")
        with self._scope(), _no_grad():
            if f == "encdec":
                return encdec.prefill(params, batch, self.cfg, max_len)
            return lm.prefill(params, batch, self.cfg, max_len)

    def decode_step(self, params: Params, state: Params,
                    tokens: torch.Tensor):
        f = self.cfg.family
        with self._scope(), _no_grad():
            if f == "ssm":
                return ssm.rwkv6_decode_step(params, state, tokens, self.cfg)
            if f == "hybrid":
                return ssm.zamba2_decode_step(params, state, tokens, self.cfg)
            if f == "encdec":
                return encdec.decode_step(params, state, tokens, self.cfg)
            return lm.decode_step(params, state, tokens, self.cfg)

    # ---- specs ---------------------------------------------------------------

    def input_specs(self, shape: ShapeConfig) -> Dict[str, BatchSpec]:
        """Batch stand-ins for one (arch x shape) cell, as the
        reference's."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": BatchSpec((b, 1), torch.int32,
                                        ("batch", None))}
        with_labels = shape.is_train
        if cfg.family == "vlm":
            p = min(cfg.frontend_tokens, s // 2)
            return {
                "patch_embeds": BatchSpec((b, p, cfg.d_model),
                                          torch.bfloat16,
                                          ("batch", None, None)),
                **_token_batch(b, s - p, with_labels),
            }
        if cfg.family == "encdec":
            t_enc = max(s // cfg.enc_frames_ratio, 1)
            return {
                "frames": BatchSpec((b, t_enc, cfg.d_model), torch.bfloat16,
                                    ("batch", None, None)),
                **_token_batch(b, s, with_labels),
            }
        return _token_batch(b, s, with_labels)

    def decode_state_specs(self, shape: ShapeConfig) -> Params:
        b, s = shape.global_batch, shape.seq_len
        long_ctx = shape.name == "long_500k"
        if self.cfg.family == "ssm":
            return ssm.rwkv6_state_specs(self.cfg, b)
        if self.cfg.family == "hybrid":
            return ssm.zamba2_state_specs(self.cfg, b, s,
                                          long_context=long_ctx)
        if self.cfg.family == "encdec":
            return encdec.decode_state_specs(self.cfg, b, s)
        return lm.decode_state_specs(self.cfg, b, s, long_context=long_ctx)

    # ---- per-slot state surgery (continuous batching) ------------------------
    #
    # Every decode-state leaf carries its logical axes in the spec tree, so the
    # batch ("slot") axis can be located per leaf and one row read or written
    # — no per-family knowledge, no batch recompute.

    def make_decode_state(self, shape: ShapeConfig) -> Params:
        """All-zeros decode state matching ``decode_state_specs(shape)``."""
        with _no_grad():
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
        with _no_grad():
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
        with _no_grad():
            tree_map(put, self.decode_state_specs(shape), state, sub)
        return state

    def slot_reset(self, shape: ShapeConfig, state: Params,
                   slot: int) -> Params:
        """Zero one slot's state (eviction) in place.  Returns ``state``."""
        def zero(spec, leaf):
            if "batch" in spec.logical:
                ax = spec.logical.index("batch")
                leaf.narrow(ax, int(slot), 1).zero_()
        with _no_grad():
            tree_map(zero, self.decode_state_specs(shape), state)
        return state


def model_api(cfg: ModelConfig, backend: Any = None,
              device: DeviceLike = None) -> ModelAPI:
    return ModelAPI(cfg, backend=backend, device=device)
