"""What the port must never do: import JAX or the JAX package, run on the
CPU unasked, or hand back a plain version where a kernel cannot be built."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch._device import resolve_device
from repro_torch.backend import get_backend
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model_api
from repro_torch.serve import ServeEngine, WaveServeEngine

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def _port_modules():
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return sorted(names)


def test_every_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert len(mods) > 40 and "repro_torch.kernels.systolic_mac" in mods
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('imported', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd="/",
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "imported" in done.stdout


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py"] + sorted(
    (SRC / "repro_torch").rglob("*.py")), ids=lambda p: p.name)
def test_source_names_no_jax_and_no_repro(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro", "flax", "triton"}, roots


def test_no_gpu_no_device_raises_everywhere(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    params = model_api(cfg, device="cpu").init_params(0)
    for entry in (lambda: resolve_device(None),
                  lambda: resolve_device("cuda"),
                  lambda: model_api(cfg),
                  lambda: model_api(cfg, device="cpu").init_params(
                      0, device="cuda"),
                  lambda: get_backend("reference"),
                  lambda: get_backend("ideal"),
                  lambda: ServeEngine(cfg, params),
                  lambda: WaveServeEngine(cfg, params),
                  lambda: launch_serve.main(["--arch", "phi4-mini-3.8b",
                                             "--smoke"])):
        with pytest.raises(RuntimeError, match="GPU|CUDA"):
            entry()
    assert resolve_device("cpu") == torch.device("cpu")
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.load_library()
    assert _build._lib is None and not (tmp_path / "build").exists()


def test_failed_compile_raises_with_the_compilers_output(monkeypatch,
                                                         tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such architecture' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    with pytest.raises(_build.KernelCompileError,
                       match="no such architecture"):
        _build.load_library()
    assert list((tmp_path / "build").glob("*")) == []      # nothing left over


def test_build_is_keyed_by_its_sources():
    srcs = _build.sources()
    assert [s.name for s in srcs] == ["systolic_mac.cu"]
    assert _build._digest(srcs) == _build._digest(srcs)
    text = srcs[0].read_text()
    for banned in ("cublas", "torch/extension.h", "ATen"):
        assert banned not in text
    assert "fmaf" in text and "systolic_mac_launch" in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_chip_smoke_fails_here_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke run would pass")
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert done.returncode != 0
    assert '"ok"' not in done.stdout and "needs a GPU" in done.stderr
