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
from repro_torch.kernels import precision_island as island_mod
from repro_torch.kernels import razor_matmul as razor_mod
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
    assert len(mods) >= 65 and "repro_torch.kernels.systolic_mac" in mods
    for name in ("repro_torch.core.cadflow", "repro_torch.flow.__main__",
                 "repro_torch.kernels.razor_matmul",
                 "repro_torch.kernels.precision_island",
                 "repro_torch.examples.precision_islands"):
        assert name in mods
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
    assert [s.name for s in srcs] == ["precision_island.cu", "quant_rows.cu",
                                      "razor_matmul.cu", "systolic_mac.cu"]
    assert _build._digest(srcs) == _build._digest(srcs)
    texts = {s.name: s.read_text() for s in srcs}
    texts.update((h.name, h.read_text())
                 for h in sorted(_build.CSRC_DIR.glob("*.cuh")))
    assert sorted(texts) == sorted(s.name for s in srcs) + [
        "tile_products.cuh"]
    for name, text in texts.items():
        for banned in ("cublas", "cutlass", "torch/extension.h", "ATen",
                       "mma.h"):
            assert banned not in text, (name, banned)
    assert "fmaf" in texts["systolic_mac.cu"]
    assert "__dp4a" in texts["tile_products.cuh"]
    for name in ("systolic_mac", "quant_rows", "razor_matmul",
                 "precision_island"):
        assert f'extern "C" int {name}_launch' in texts[f"{name}.cu"]
    # true IEEE division and round-half-even in the quantizer
    assert "__fdiv_rn" in texts["quant_rows.cu"]
    assert "rintf" in texts["quant_rows.cu"]
    assert "floorf" not in texts["quant_rows.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f
                   for f in _build.NVCC_FLAGS)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on a GPU: what a wrapper sees of a
    CUDA tensor before it launches anything."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel", ["razor_matmul", "precision_island"])
def test_cuda_tensors_raise_without_nvcc_and_never_take_the_plain_version(
        kernel, monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)

    def plain(*args, **kw):
        raise AssertionError("the plain version served a CUDA tensor")

    monkeypatch.setattr(razor_mod, "razor_matmul_plain", plain)
    monkeypatch.setattr(island_mod, "precision_island_plain", plain)
    a = torch.zeros(256, 64).as_subclass(_CudaLooking)
    b = torch.zeros(64, 256).as_subclass(_CudaLooking)
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        if kernel == "razor_matmul":
            razor_mod.razor_matmul(a, b)
        else:
            tiers = torch.zeros(2, 2, dtype=torch.int32).as_subclass(
                _CudaLooking)
            island_mod.precision_island(a, b, tiers)
    assert razor_mod.razor_matmul.launches == 0
    assert island_mod.precision_island.launches == 0


def test_chip_smoke_fails_here_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke run would pass")
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert done.returncode != 0
    assert '"ok"' not in done.stdout and "needs a GPU" in done.stderr
