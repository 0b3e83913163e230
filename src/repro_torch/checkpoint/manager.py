"""Sharded checkpointing with async writes, atomic publication and elastic
resharding (DESIGN.md Sec. 7).  Counterpart of
``repro.checkpoint.manager``, with its layout, so a checkpoint written by
either package restores in the other.

Layout:  <dir>/step_<n>/manifest.json + shard_<host>.npz
The manifest records the tree structure (leaf names are the dict keys of
the path joined with ``/``), per-leaf global shape/dtype and the writing
host count, so a restore may target a *different* host count — leaves are
reassembled from shards.

npz cannot hold bfloat16: a bf16 leaf is stored as its raw uint16 bits
(through torch's int16 view; numpy here needs no ``ml_dtypes``) and
reinterpreted on restore from the manifest's logical dtype, as the
reference does.  Leaves may be tensors (any device) or numpy arrays;
:meth:`CheckpointManager.restore` writes into the template's tensors in
place and returns them (a new CPU tensor for a numpy template leaf), where
the reference returns new numpy arrays.  On a device mesh a ``DTensor``
leaf is saved whole (``full_tensor()``, gathered on every rank; rank 0
writes, as the reference saves gathered arrays) and restored into each
rank's shard of the template.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import is_dtensor

Pytree = Any

_SEP = "/"


def _snapshot(leaf: Any) -> Tuple[np.ndarray, str]:
    """(a numpy copy of ``leaf`` with bf16 as uint16 bits, its logical dtype
    name).  Always a copy: on the CPU ``Tensor.numpy()`` aliases the
    tensor's buffer, and the optimizer updates in place, so an async write
    must not read the live tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if is_dtensor(t):
            t = t.full_tensor()         # the gathered leaf, on every rank
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).to("cpu", copy=True).numpy()
            return bits.view(np.uint16), "bfloat16"
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":            # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _writes() -> bool:
    """Whether this process writes a checkpoint: rank 0 of the default
    process group, or a process with none (every rank gathers a mesh's
    leaves, one writes them)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _decode(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=logical_dtype))


def _flatten_with_names(tree: Pytree, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    """(name, leaf) in sorted-key order, as ``jax.tree_util`` orders a
    dict."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_names(tree[k], f"{prefix}{k}{_SEP}")
        return out
    return [(prefix[:-len(_SEP)], tree)]


def _unflatten_like(template: Pytree, named: Dict[str, Any],
                    prefix: str = "") -> Pytree:
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], named, f"{prefix}{k}{_SEP}")
                for k in template}
    return named[prefix[:-len(_SEP)]]


def _place(leaf: Any, value: torch.Tensor, key: str) -> torch.Tensor:
    """``value`` written into the template's tensor ``leaf`` in place, so
    a restore adds no second copy of the state on the leaf's device; a
    numpy template leaf gives ``value`` itself, on the CPU."""
    if not isinstance(leaf, torch.Tensor):
        return value
    if leaf.shape != value.shape or leaf.dtype != value.dtype:
        raise ValueError(f"{key}: the checkpoint holds "
                         f"{tuple(value.shape)} {value.dtype}, the template "
                         f"{tuple(leaf.shape)} {leaf.dtype}")
    with torch.no_grad():
        if is_dtensor(leaf):
            # this rank's shard of the whole value
            from torch.distributed.tensor import distribute_tensor
            part = distribute_tensor(value.to(leaf.device), leaf.device_mesh,
                                     leaf.placements)
            leaf.to_local().copy_(part.to_local())
        else:
            leaf.copy_(value)
    return leaf


class CheckpointManager:
    """Host-sharded npz checkpoints.

    ``num_hosts``/``host_id`` simulate the multi-host layout: each host
    writes the rows of every leaf's leading axis it owns (leaves whose
    leading dim doesn't divide are written whole by host 0).
    """

    def __init__(self, directory: str | Path, host_id: int = 0,
                 num_hosts: int = 1, keep: int = 3):
        self.dir = Path(directory)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # -- helpers -----------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def _owned_slice(self, arr: np.ndarray, host: int) -> np.ndarray:
        n = arr.shape[0] if arr.ndim else 0
        if arr.ndim == 0 or n % self.num_hosts:
            return arr if host == 0 else arr[:0] if arr.ndim else arr
        per = n // self.num_hosts
        return arr[host * per:(host + 1) * per]

    # -- save --------------------------------------------------------------------

    def save(self, step: int, tree: Pytree, blocking: bool = True) -> Path:
        """Write ``tree``'s leaves at ``step``.  The leaves are copied to the
        host before this returns, also with ``blocking=False``: only the
        file writes run on the background thread."""
        named = [(k, *_snapshot(v)) for k, v in _flatten_with_names(tree)]
        tmp = self.dir / f".tmp_step_{step:08d}_{self.host_id}"
        final = self._step_dir(step)

        def _write() -> None:
            tmp.mkdir(parents=True, exist_ok=True)
            shard = {k: self._owned_slice(v, self.host_id)
                     for k, v, _ in named}
            np.savez(tmp / f"shard_{self.host_id}.npz", **shard)
            if self.host_id == 0:
                manifest = {
                    "step": step,
                    "num_hosts": self.num_hosts,
                    "leaves": {k: {"shape": list(v.shape), "dtype": dtype}
                               for k, v, dtype in named},
                }
                (tmp / "manifest.json").write_text(json.dumps(manifest))
            # atomic publication: rename once the shard is complete
            final.mkdir(parents=True, exist_ok=True)
            for f in tmp.iterdir():
                os.replace(f, final / f.name)
            shutil.rmtree(tmp, ignore_errors=True)
            self._gc()

        if not _writes():
            return final
        if blocking:
            _write()
        else:
            self.wait()
            self._async_thread = threading.Thread(target=_write, daemon=True)
            self._async_thread.start()
        return final

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Pytree, step: Optional[int] = None) -> Pytree:
        """Reassemble the full tree from however many shards were written
        (elastic: the reading topology is independent of the writing one),
        written into the template's tensors in place and returned in the
        template's structure.  Each leaf passes through the host on its own,
        so neither the device nor the host holds a second copy of the
        state."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        named: Dict[str, Any] = {}
        shards = [np.load(d / f"shard_{h}.npz")
                  for h in range(manifest["num_hosts"])]
        try:
            for key, leaf in _flatten_with_names(template):
                meta = manifest["leaves"][key]
                parts = [s[key] for s in shards]
                parts = [p for p in parts if p.size or p.ndim == 0]
                if len(parts) == 1 or parts[0].ndim == 0:
                    arr = parts[0]
                else:
                    arr = np.concatenate(parts, axis=0)
                expect = tuple(meta["shape"])
                if arr.shape != expect:
                    raise ValueError(f"{key}: restored {arr.shape} != "
                                     f"{expect}")
                named[key] = _place(leaf, _decode(arr, meta["dtype"]), key)
        finally:
            for s in shards:
                s.close()
        return _unflatten_like(template, named)
