"""Logical-axis sharding: one place that maps model-level axis names onto a
device mesh.  Counterpart of ``repro.models.shardlib``.

Params and activations carry *logical* axes ("fsdp", "tp", "batch",
"seq_tp", ...).  :class:`Rules` resolves them to mesh axes; the same model
code then runs on the production (16, 16) and (2, 16, 16) meshes, the small
test meshes, or no mesh at all (rules resolve to fully replicated).

Where the reference hands XLA a ``PartitionSpec``, the port hands
``torch.distributed.tensor`` a list of placements, one per mesh axis
(:meth:`Rules.placements`): a tensor dimension that several mesh axes split
becomes several ``Shard(d)``, in mesh-axis order, as GSPMD orders a tuple
of axes.  With a mesh, parameters, optimizer state and batches are
``DTensor`` s (:func:`distribute_tree`) and the model's ops propagate their
placements; :func:`shard` is the reference's ``with_sharding_constraint``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple, Union

import torch

from .._device import is_dtensor

MeshAxes = Union[None, str, Tuple[str, ...]]


def _mesh_axes(mesh: Any) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axis_size(mesh: Any, name: str) -> int:
    return int(mesh.size(_mesh_axes(mesh).index(name)))


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical-axis -> mesh-axis mapping; ``mesh`` is a
    ``torch.distributed.device_mesh.DeviceMesh`` or None."""

    table: Mapping[str, MeshAxes]
    mesh: Optional[Any] = None

    def resolve(self, logical: Sequence[Optional[str]]) -> Tuple[MeshAxes,
                                                                 ...]:
        """Logical -> the reference's ``PartitionSpec`` as a plain tuple,
        de-duplicating mesh axes (first dim that claims an axis wins —
        needed for layouts like tp2d where 'tp' spans every axis and would
        otherwise collide with 'batch')."""
        out = []
        used: set = set()
        for name in logical:
            if name is None:
                out.append(None)
                continue
            if name not in self.table:
                raise KeyError(f"unknown logical axis {name!r}")
            axes = self.table[name]
            if axes is None:
                out.append(None)
                continue
            tup = (axes,) if isinstance(axes, str) else tuple(axes)
            free = tuple(a for a in tup if a not in used)
            used.update(free)
            if not free:
                out.append(None)
            elif len(free) == 1:
                out.append(free[0])
            else:
                out.append(free)
        return tuple(out)

    def placements(self, logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        """DTensor placements (one per mesh axis) of a tensor with these
        logical axes.  With ``shape``, a dimension that its mesh axes do
        not divide is left replicated (:func:`shard`'s rule)."""
        from torch.distributed.tensor import Replicate, Shard
        if self.mesh is None:
            raise ValueError("placements need rules with a mesh")
        spec = self.resolve(logical)
        out = [Replicate() for _ in _mesh_axes(self.mesh)]
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            tup = (axes,) if isinstance(axes, str) else axes
            if shape is not None and shape[dim] % _axes_size(self.mesh,
                                                            tup):
                continue
            for a in tup:
                out[_mesh_axes(self.mesh).index(a)] = Shard(dim)
        return tuple(out)

    def sharding(self, logical: Sequence[Optional[str]]):
        """``(mesh, placements)``, or None without a mesh (the reference's
        ``NamedSharding``)."""
        if self.mesh is None:
            return None
        return self.mesh, self.placements(logical)


def single_pod_rules(mesh: Optional[Any] = None) -> Rules:
    """(16, 16) ("data", "model"): DP+FSDP over data, TP over model."""
    return Rules({
        "layers": None,
        "batch": "data",
        "fsdp": "data",            # ZeRO-style parameter/optimizer sharding
        "tp": "model",             # heads / ffn / vocab / experts
        "expert": "model",
        "seq_tp": "model",         # sequence-sharded KV caches (decode)
        "seq_full": ("data", "model"),  # long-context single-batch caches
        "none": None,
    }, mesh)


def multi_pod_rules(mesh: Optional[Any] = None) -> Rules:
    """(2, 16, 16) ("pod", "data", "model"): pod joins the data axis."""
    return Rules({
        "layers": None,
        "batch": ("pod", "data"),
        "fsdp": ("pod", "data"),
        "tp": "model",
        "expert": "model",
        "seq_tp": "model",
        "seq_full": ("pod", "data", "model"),
        "none": None,
    }, mesh)


def replicated_rules() -> Rules:
    """All logical axes resolve to replication — no mesh."""
    return Rules({k: None for k in ("layers", "batch", "fsdp", "tp", "expert",
                                    "seq_tp", "seq_full", "none")})


_STATE = threading.local()


def current_rules() -> Rules:
    return getattr(_STATE, "rules", None) or replicated_rules()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Make ``rules`` the active rules of this thread.  With a mesh, plain
    tensors the model makes inside the block (positions, masks) count as
    replicated where they meet a ``DTensor``
    (``torch.distributed.tensor.experimental.implicit_replication``)."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        if rules is not None and rules.mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield rules
        else:
            yield rules
    finally:
        _STATE.rules = prev


def _axes_size(mesh: Any, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return _axis_size(mesh, axes)
    return math.prod(_axis_size(mesh, a) for a in axes)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the active rules' placements, and its gradient
    likewise (the reference's ``with_sharding_constraint``); the identity
    where the rules carry no mesh or ``x`` is not a ``DTensor``.

    Dims whose size the mapped mesh axes do not divide are left
    replicated, so alternate layouts like 256-way tp2d can be applied to
    weights without invalidating every activation hint."""
    rules = current_rules()
    if rules.mesh is None or not is_dtensor(x):
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"rank mismatch: {logical} vs {tuple(x.shape)}")
    target = rules.placements(logical, tuple(x.shape))
    if tuple(x.placements) == target and not x.requires_grad:
        return x
    return _Constrain.apply(x, target)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``target``, and the gradient likewise: as XLA
    transposes a sharding constraint into one on the cotangent.  Without
    it a gradient that reaches ``x`` replicated (the backward of a sum
    expands a replicated scalar) would keep every rank's activation
    gradients whole, and so the weight-gradient products."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.home = tuple(x.placements)
        ctx.target = target
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        mesh = g.device_mesh
        g = g.redistribute(mesh, ctx.target)
        home = [Replicate() if p.is_partial() else p for p in ctx.home]
        # a split of the last dimension leaves each rank a strided view,
        # which a later reshape cannot view
        return g.redistribute(mesh, home).contiguous(), None


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype + logical axes of one parameter tensor."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Tuple[Optional[str], ...]
    init: str = "normal"            # "normal" | "zeros" | "ones" | "embed"

    def struct(self) -> torch.Tensor:
        """A ``meta`` tensor of this shape and dtype (the reference's
        ``ShapeDtypeStruct``)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dictionaries that share one
    structure (a leaf is anything that is not a ``dict``); keys are visited
    in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def spec_tree_to_structs(tree: Any) -> Any:
    return tree_map(lambda s: s.struct(), tree)


def spec_tree_to_shardings(tree: Any, rules: Rules) -> Any:
    return tree_map(lambda s: rules.sharding(s.logical), tree)


def spec_tree_to_pspecs(tree: Any, rules: Rules) -> Any:
    return tree_map(lambda s: rules.resolve(s.logical), tree)


def distribute_tree(tree: Any, specs: Any, rules: Rules) -> Any:
    """Place a tree of whole tensors (every rank holds the same values, on
    the mesh's device type) onto the rules' mesh: each leaf becomes a
    ``DTensor`` with its spec's placements (a dimension its axes do not
    divide stays replicated).  On a one-rank mesh each leaf is its own
    shard and is not copied (an inference tensor is).  Without a mesh the
    tree comes back as it is."""
    if rules.mesh is None:
        return tree
    from torch.distributed.tensor import DTensor, distribute_tensor
    whole = rules.mesh.size() == 1

    def put(leaf, spec):
        placements = list(rules.placements(spec.logical, tuple(leaf.shape)))
        if leaf.is_inference():
            # a mesh step runs under no_grad, where an inference tensor
            # cannot be written in place (a decode state)
            leaf = leaf.clone()
        if whole:
            return DTensor.from_local(leaf.detach(), rules.mesh, placements,
                                      run_check=False)
        return distribute_tensor(leaf.detach(), rules.mesh, placements)
    return tree_map(put, tree, specs)


def init_param(gen: torch.Generator, s: ParamSpec,
               device: torch.device) -> torch.Tensor:
    """One parameter: zeros, ones, or a normal draw scaled by
    ``1/sqrt(fan_in)`` (0.02 for the embedding), drawn in f32 and cast."""
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    scale = 0.02 if s.init == "embed" else 1.0 / math.sqrt(fan_in)
    x = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(s.dtype)


def init_param_tree(gen: torch.Generator, tree: Any,
                    device: torch.device) -> Any:
    """Initialise a spec tree leaf by leaf (sorted key order) from one
    generator, which must live on ``device``."""
    return tree_map(lambda s: init_param(gen, s, device), tree)


def param_count(tree: Any) -> int:
    """Number of scalars in a tree of specs or tensors."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))
