"""Step builders: train / prefill / decode / forward functions for any
(arch x shape x mesh) cell.  Counterpart of ``repro.launch.steps``.

The reference jits each step with full in/out shardings and lowers it
abstractly for any mesh.  The port's steps run eagerly: ``BuiltStep.fn`` is
the plain callable, run under the step's rules (``DTensor`` arguments on a
mesh, plain tensors without one), and ``arg_structs`` holds ``meta``
tensors of the arguments' global shapes and dtypes.

:meth:`BuiltStep.lower` is the port's stand-in for ``jit(...).lower()``:
it traces the step once on the active process group (a ``fake`` group of
any size, ``launch.mesh.start_mesh``) under ``FakeTensorMode``, with no data
and no memory, and returns a :class:`LoweredStep` of what each rank would
hold, compute and exchange.  There is no ``.compile()``: the port runs
eagerly (ROADMAP C4).  Under ``FakeTensorMode`` the model runs on device
``cpu``, so the recurrences take their plain versions (``wkv6_plain``,
``ssd_chunk_plain``): the same work as the reference's chunked jnp forms.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import optim
from .._device import DeviceLike
from ..configs import get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..models import model_api
from ..models.api import BatchSpec, ModelAPI
from ..models.shardlib import (Rules, is_dtensor, spec_tree_to_structs,
                               tree_map, use_rules)
from ..roofline.comms import CollectiveOp, functional_kind
from ..train.trainer import check_rules, make_train_step

Pytree = Any


def _device(rules: Optional[Rules], device: DeviceLike) -> DeviceLike:
    """A mesh's steps run on its device type unless told otherwise."""
    if device is None and rules is not None and rules.mesh is not None:
        return rules.mesh.device_type
    return device


# ---------------------------------------------------------------------------
# Lowering: one traced step on fake tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoweredStep:
    """What one rank holds, computes and exchanges in one step: the port's
    stand-in for XLA's lowered-and-compiled step.

    ``memory``: ``argument_bytes`` (the rank's shards of every argument),
    ``output_bytes`` (of every output), ``alias_bytes`` (outputs that are
    arguments written in place), ``temp_bytes`` (the peak of live tensors
    the step made, its outputs excluded).  ``cost``: ``flops`` (the rank's
    local ops through ``torch.utils.flop_counter``'s formulas, the ones
    ``FlopCounterMode`` uses) and ``bytes accessed`` (every dispatched op's
    input and output bytes, views excepted: an unfused upper bound, as
    XLA:CPU's).
    ``collectives``: each ``_c10d_functional`` collective with its result
    bytes and group size."""

    kind: str
    memory: Dict[str, int]
    cost: Dict[str, float]
    collectives: List[CollectiveOp]
    trace_s: float


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_shape(shape: Tuple[int, ...], mesh, placements) -> Tuple[int,
                                                                    ...]:
    """This rank's shard shape (DTensor's ``torch.chunk`` split: shards
    of ceil(size / parts), the last ones shorter or empty)."""
    out = list(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        d, n = pl.dim, mesh.size(i)
        size = -(-out[d] // n)
        out[d] = max(0, min(size, out[d] - coord[i] * size))
    return tuple(out)


def _fake_arg(spec, rules: Optional[Rules]) -> torch.Tensor:
    """A data-free stand-in of one argument leaf: a ``DTensor`` over this
    rank's fake shard on a mesh, a fake tensor without one (call under
    ``FakeTensorMode``)."""
    shape, dtype = tuple(spec.shape), spec.dtype
    if rules is None or rules.mesh is None:
        return torch.empty(shape, dtype=dtype, device="cpu")
    from torch.distributed.tensor import DTensor
    placements = rules.placements(spec.logical, shape)
    local = torch.empty(_local_shape(shape, rules.mesh, placements),
                        dtype=dtype, device=rules.mesh.device_type)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, rules.mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _tensors(tree: Pytree) -> List[torch.Tensor]:
    """Every tensor of nested dicts, lists and tuples, ``DTensor`` s as
    this rank's shard."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if is_dtensor(tree) else tree]
    return []


def _local_bytes(tree: Pytree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def _storages(tree: Pytree) -> set:
    return {t.untyped_storage()._cdata for t in _tensors(tree)}


class _StepCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts each rank's local ops: ``DTensor``-level ops are handed back
    to ``DTensor`` (``NotImplemented``), which runs them as local ops and
    collectives that come back here.  Also tracks the live bytes of the
    tensors made (by storage) and their peak."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: List[CollectiveOp] = []
        self.live: Dict[int, List[int]] = {}      # storage -> [bytes, refs]
        self.live_bytes = 0
        self.peak = 0

    def _release(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    def _track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak = max(self.peak, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat_in = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        if (any(a.device.type == "meta" for a in flat_in)
                or _in_meta_propagation()):
            # DTensor's sharding propagation runs the op on global-shape
            # stand-ins to learn its output's shape: no rank runs it
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        flat_out = [o for o in torch.utils._pytree.tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = functional_kind(name)
            if kind is not None:
                self.collectives.append(CollectiveOp(
                    kind=kind, result_bytes=sum(_nbytes(o) for o in flat_out),
                    group=_group_size(args, kwargs), line=f"{ns}.{name}"))
            return out
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:            # a view moves no bytes
            self.bytes += sum(_nbytes(t) for t in flat_in + flat_out)
        in_keys = {t.untyped_storage()._cdata for t in flat_in}
        for o in flat_out:
            if o.untyped_storage()._cdata not in in_keys:
                self._track(o)
        return out


def _in_meta_propagation() -> bool:
    """Whether DTensor's sharding propagator is the caller (it runs an op
    once on fake tensors of the global shapes, per new input layout)."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        frame = frame.f_back
    return False


def _group_size(args, kwargs) -> int:
    """Participants of a functional collective, from its group name."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = kwargs.get("group_name")
    if name is None:
        strs = [a for a in args if isinstance(a, str)]
        name = strs[-1] if strs else None
    if name is None:
        return 1
    return _resolve_process_group(name).size()


def _trace(fn, arg_specs: Tuple[Pytree, ...], rules: Optional[Rules],
           kind: str) -> LoweredStep:
    """Run ``fn`` once on fake stand-ins of ``arg_specs``' leaves."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.monotonic()
    with FakeTensorMode():
        args = tuple(tree_map(lambda s: _fake_arg(s, rules), specs)
                     for specs in arg_specs)
        arg_bytes = _local_bytes(args)
        arg_keys = _storages(args)
        counter = _StepCounter()
        with counter:
            out = fn(*args)
            out_bytes = _local_bytes(out)
            out_keys = _storages(out)
            alias = sum(_nbytes(t) for t in _tensors(out)
                        if t.untyped_storage()._cdata in arg_keys)
            made_out = sum(counter.live[k][0] for k in out_keys - arg_keys
                           if k in counter.live)
        temp = max(counter.peak - made_out, 0)
    return LoweredStep(
        kind=kind,
        memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                "temp_bytes": temp, "alias_bytes": alias},
        cost={"flops": float(counter.flops),
              "bytes accessed": float(counter.bytes)},
        collectives=counter.collectives,
        trace_s=time.monotonic() - t0)


@dataclasses.dataclass
class BuiltStep:
    """A step callable plus stand-ins of its arguments."""

    fn: Any                      # the step callable
    arg_structs: Tuple[Pytree, ...]
    kind: str                    # train | prefill | decode
    cfg: ModelConfig
    api: ModelAPI
    rules: Optional[Rules] = None   # None: one device holds everything
    arg_specs: Tuple[Pytree, ...] = ()   # ParamSpec / BatchSpec trees

    def lower(self) -> LoweredStep:
        """Trace the step once without data on the rules' mesh (or one
        device): see :class:`LoweredStep`."""
        return _trace(self.fn, self.arg_specs, self.rules, self.kind)


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     rules: Optional[Rules] = None,
                     opt_cfg: Optional[optim.AdamWConfig] = None,
                     device: DeviceLike = None) -> BuiltStep:
    check_rules(rules)
    api = model_api(cfg, device=_device(rules, device))
    opt_cfg = opt_cfg or optim.AdamWConfig()
    pspecs = api.param_specs()
    ospecs = optim.state_specs(pspecs, opt_cfg)
    bspecs = api.input_specs(shape)
    fn = make_train_step(api, cfg, opt_cfg, rules)
    args = (spec_tree_to_structs(pspecs), spec_tree_to_structs(ospecs), spec_tree_to_structs(bspecs))
    return BuiltStep(fn, args, "train", cfg, api, rules,
                     (pspecs, ospecs, bspecs))


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       rules: Optional[Rules] = None,
                       device: DeviceLike = None) -> BuiltStep:
    check_rules(rules)
    api = model_api(cfg, device=_device(rules, device))
    pspecs = api.param_specs()
    bspecs = api.input_specs(shape)

    def prefill_step(params, batch):
        with use_rules(rules):
            return api.prefill(params, batch, max_len=shape.seq_len)

    args = (spec_tree_to_structs(pspecs), spec_tree_to_structs(bspecs))
    return BuiltStep(prefill_step, args, "prefill", cfg, api, rules,
                     (pspecs, bspecs))


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      rules: Optional[Rules] = None,
                      device: DeviceLike = None) -> BuiltStep:
    """The decode step writes its state in place (the reference's
    ``donate=True``; there is no copying form)."""
    check_rules(rules)
    api = model_api(cfg, device=_device(rules, device))
    pspecs = api.param_specs()
    sspecs = api.decode_state_specs(shape)
    tokens = BatchSpec((shape.global_batch, 1), torch.int32, ("batch", None))

    def decode_step(params, state, toks):
        with use_rules(rules):
            return api.decode_step(params, state, toks)

    args = (spec_tree_to_structs(pspecs), spec_tree_to_structs(sspecs), tokens.struct())
    return BuiltStep(decode_step, args, "decode", cfg, api, rules,
                     (pspecs, sspecs, tokens))


def build_cell(arch: str, shape: ShapeConfig, mesh: Any,
               smoke: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               opt_cfg: Optional[optim.AdamWConfig] = None) -> BuiltStep:
    """One (arch x shape) cell on a mesh: picks the right step kind and
    the mesh's rules (``long_500k`` spreads caches over every axis; a
    ``tp2d`` serving layout keeps weights stationary)."""
    from .mesh import rules_for_mesh, tp2d_rules
    cfg = get_config(arch, smoke=smoke)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    long_ctx = shape.name == "long_500k"
    rules = rules_for_mesh(mesh, long_context=long_ctx)
    if shape.kind != "train" and cfg.serve_weight_layout == "tp2d":
        rules = tp2d_rules(mesh, long_context=long_ctx)
    if shape.kind == "train":
        return build_train_step(cfg, shape, rules, opt_cfg)
    if shape.kind == "prefill":
        if cfg.family in ("ssm", "hybrid"):
            # SSM prompts are absorbed via chunked forward = the train fwd;
            # lower the loss-forward as the prefill-compute proxy
            return build_forward_step(cfg, shape, rules)
        return build_prefill_step(cfg, shape, rules)
    return build_decode_step(cfg, shape, rules)


def build_forward_step(cfg: ModelConfig, shape: ShapeConfig,
                       rules: Optional[Rules] = None,
                       device: DeviceLike = None) -> BuiltStep:
    """Forward-only (no grad) step — SSM/hybrid prefill proxy."""
    check_rules(rules)
    api = model_api(cfg, device=_device(rules, device))
    pspecs = api.param_specs()
    train_like = ShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                             "train")
    bspecs = api.input_specs(train_like)

    def fwd(params, batch):
        with use_rules(rules):
            return api.loss(params, batch)

    args = (spec_tree_to_structs(pspecs), spec_tree_to_structs(bspecs))
    return BuiltStep(fwd, args, "prefill", cfg, api, rules, (pspecs, bspecs))
