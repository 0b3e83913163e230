"""The port's checkpoints (``repro_torch.checkpoint``) against
``repro.checkpoint``: the same layout, so a checkpoint written by either
package restores in the other, bf16 leaves included, whole or from four
host shards (elastic).  Restored values must be bit-equal; the port
restores into the template's tensors in place, the reference into new numpy
arrays.  The twins of the reference's own checkpoint tests
(``tests/substrate/test_substrates.py``) run on the port.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager


def _torch_tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"blocks": {"w": torch.randn((8, 3, 4), generator=gen
                                                   ).to(torch.bfloat16)},
                       "norm": torch.ones(5)},
            "opt": {"per_param": {"mu": torch.randn((8, 3), generator=gen),
                                  "q": torch.randint(-127, 127, (6, 2),
                                                     generator=gen,
                                                     dtype=torch.int8)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _as_numpy(t):
    """A torch leaf as the reference holds it (bf16 as ml_dtypes)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return _as_numpy(tree)


def _bits(x):
    """The raw bytes and dtype name of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        return _as_numpy(x).tobytes(), str(x.dtype).replace("torch.", "")
    x = np.asarray(x)
    return x.tobytes(), x.dtype.name


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
        return
    g, w = _bits(got), _bits(want)
    assert g == w
    assert tuple(got.shape) == tuple(np.shape(want))


@pytest.mark.parametrize("hosts", [1, 4])
def test_port_checkpoint_restores_in_the_reference(tmp_path, hosts):
    tree = _torch_tree()
    for h in range(hosts):
        CheckpointManager(tmp_path, host_id=h, num_hosts=hosts).save(3, tree)
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["params/blocks/w"]["dtype"] == "bfloat16"
    assert manifest["num_hosts"] == hosts
    out = JCheckpointManager(tmp_path).restore(_numpy_tree(tree))
    assert out["params"]["blocks"]["w"].dtype == jnp.bfloat16
    _assert_same(tree, out)


@pytest.mark.parametrize("hosts", [1, 4])
def test_reference_checkpoint_restores_in_the_port(tmp_path, hosts):
    tree = _numpy_tree(_torch_tree(1))
    for h in range(hosts):
        JCheckpointManager(tmp_path, host_id=h, num_hosts=hosts).save(9, tree)
    template = _torch_tree()
    out = CheckpointManager(tmp_path).restore(template)
    assert out["params"]["blocks"]["w"].dtype == torch.bfloat16
    assert out["opt"]["step"].dtype == torch.int32
    assert all(isinstance(x, torch.Tensor) for x in (
        out["params"]["norm"], out["opt"]["per_param"]["q"]))
    _assert_same(out, tree)


def test_async_save_snapshots_before_the_tensors_change(tmp_path):
    """On the CPU ``Tensor.numpy()`` aliases the tensor: the optimizer's
    in-place update right after ``save(blocking=False)`` returns must not
    reach the checkpoint."""
    tree = _torch_tree()
    want = {k: v.clone() for k, v in tree["params"]["blocks"].items()}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree, blocking=False)
    tree["params"]["blocks"]["w"].add_(1.0)
    tree["opt"]["step"].add_(1)
    mgr.wait()
    out = mgr.restore(_torch_tree())
    assert torch.equal(out["params"]["blocks"]["w"], want["w"])
    assert int(out["opt"]["step"]) == 7


def test_restore_puts_leaves_on_the_template_device(tmp_path):
    """A restore writes into the template's tensors and returns them, so
    the device never holds a second copy of the state (a full-width
    phi4-mini resume would not fit twice on an 80 GB card); a numpy
    template leaf comes back as a CPU tensor."""
    tree = _torch_tree()
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, tree)
    template = _torch_tree(5)
    template["params"]["norm"] = np.zeros(5, np.float32)
    ptrs = {k: v.data_ptr() for k, v in template["opt"]["per_param"].items()}
    w = template["params"]["blocks"]["w"]
    out = mgr.restore(template)
    assert out["params"]["blocks"]["w"] is w
    assert {k: v.data_ptr() for k, v in out["opt"]["per_param"].items()} \
        == ptrs
    assert out["opt"]["step"] is template["opt"]["step"]
    assert isinstance(out["params"]["norm"], torch.Tensor)
    assert out["params"]["norm"].device.type == "cpu"
    _assert_same(out, tree)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_restore_refuses_a_template_leaf_of_another_shape_or_dtype(
        tmp_path, bad):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.zeros(3)})
    leaf = (torch.zeros(4) if bad == "shape"
            else torch.zeros(3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="x: the checkpoint holds"):
        mgr.restore({"x": leaf})


# ---- twins of tests/substrate/test_substrates.py's checkpoint tests ----------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(4, 3),
            "nest": {"b": torch.ones((2, 2), dtype=torch.int32)},
            "scalar": torch.tensor(3.5, dtype=torch.float32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(10, tree)
    out = mgr.restore(tree)
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["nest"]["b"], tree["nest"]["b"])
    assert out["scalar"] == tree["scalar"]
    assert mgr.latest_step() == 10


def test_checkpoint_elastic_reshard(tmp_path):
    """Write with 4 hosts, restore on 1 (and vice versa)."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    writers = [CheckpointManager(tmp_path, host_id=h, num_hosts=4)
               for h in range(4)]
    for w in writers:
        w.save(5, tree)
    reader = CheckpointManager(tmp_path, host_id=0, num_hosts=1)
    out = reader.restore(tree)
    assert torch.equal(out["w"], tree["w"])


def test_checkpoint_async_and_gc(tmp_path):
    tree = {"x": torch.ones((4,), dtype=torch.float32)}
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=False)
        mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.zeros(3)})
    mgr.save(2, {"x": torch.ones(3)})
    out = mgr.restore({"x": torch.zeros(3)}, step=1)
    assert torch.equal(out["x"], torch.zeros(3))


def test_the_training_modules_import_without_ml_dtypes():
    """The card's Python has no ``ml_dtypes``: the port's checkpoints keep
    bf16 through torch, and no training module imports it."""
    code = ("import sys\n"
            "import repro_torch.checkpoint, repro_torch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.launch.steps, "
            "repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ml_dtypes', 'jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
