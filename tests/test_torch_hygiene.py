"""What the port must never do: import JAX or the JAX package, run on the
CPU unasked, or hand back a plain version where a kernel cannot be built."""

import ast
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch._device import resolve_device
from repro_torch.backend import get_backend
from repro_torch.configs import get_config
from repro_torch.flow import FlowConfig
from repro_torch.flow import run as flow_run
from repro_torch.hwloop import HwLoopSession, hwloop_pipeline
from repro_torch.kernels import _build
from repro_torch.kernels import abft as abft_mod
from repro_torch.kernels import precision_island as island_mod
from repro_torch.kernels import razor_matmul as razor_mod
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model_api
from repro_torch.models import ssm as ssm_mod
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
                 "repro_torch.examples.precision_islands",
                 "repro_torch.kernels.wkv6", "repro_torch.kernels.ssd_chunk",
                 "repro_torch.models.ssm"):
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
                                             "--smoke"]),
                  lambda: model_api(get_config("rwkv6-1.6b", smoke=True)),
                  lambda: model_api(get_config("zamba2-2.7b", smoke=True)),
                  lambda: launch_serve.main(["--arch", "rwkv6-1.6b",
                                             "--smoke"]),
                  lambda: get_backend("emulated"),
                  lambda: get_backend("simulated"),
                  lambda: HwLoopSession(FlowConfig(array_n=8,
                                                   max_trials=8)),
                  lambda: flow_run(FlowConfig(array_n=8, max_trials=8,
                                              hwloop_steps=1),
                                   pipeline=hwloop_pipeline()),
                  lambda: launch_serve.main(["--arch", "phi4-mini-3.8b",
                                             "--smoke", "--backend",
                                             "emulated", "--hwloop"])):
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
    assert [s.name for s in srcs] == ["abft_checksums.cu",
                                      "precision_island.cu", "quant_rows.cu",
                                      "razor_matmul.cu", "ssd_chunk.cu",
                                      "ssd_chunk_bwd.cu", "systolic_mac.cu",
                                      "wkv6.cu", "wkv6_bwd.cu"]
    assert _build._digest(srcs) == _build._digest(srcs)
    texts = {s.name: s.read_text() for s in srcs}
    texts.update((h.name, h.read_text())
                 for h in sorted(_build.CSRC_DIR.glob("*.cuh")))
    assert sorted(texts) == sorted([s.name for s in srcs]
                                   + ["tc_ring.cuh", "tf32_tiles.cuh"])
    for name, text in texts.items():
        for banned in ("cublas", "cutlass", "torch/extension.h", "ATen",
                       "mma.h"):
            assert banned not in text, (name, banned)
    # systolic_mac: bf16 on the tensor cores by inline PTX mma.sync at
    # every M, bulk-copy streaming, f32 kept on fmaf (no TF32)
    assert "mma.sync.aligned.m16n8k16" in texts["systolic_mac.cu"]
    assert "cp.async.bulk" in texts["systolic_mac.cu"]
    assert "fmaf" in texts["systolic_mac.cu"]
    assert ".tf32" not in texts["systolic_mac.cu"]
    # razor_matmul and precision_island share tc_ring.cuh: the int8 products
    # on the tensor cores into int32 (wgmma for bf16 operands, mma.sync for
    # f32), the bf16 products on the bf16 tensor cores (wgmma), the f32
    # products by a 3xTF32 split, TMA streaming; no __dp4a and no float
    # atomics (razor_matmul's count is an integer atomicAdd)
    ring = texts["tc_ring.cuh"]
    assert "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8" in ring
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in ring
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in ring
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in ring
    assert "lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));" in ring
    assert "cp.async.bulk.tensor" in ring
    assert not re.findall(r"atomic\w*\(", ring)
    razor = texts["razor_matmul.cu"]
    assert re.findall(r"atomic\w+\([^,]+", razor) == ["atomicAdd(count"]
    island = texts["precision_island.cu"]
    assert not re.findall(r"atomic\w*\(", island)
    for src in (razor, island):
        assert '#include "tc_ring.cuh"' in src
        for call in ("issue_s8_tile(", "issue_bf16_tile<", "s8_tile(Qa",
                     "tf32_tile<", "tma_float_tiles<", "tma_int_tiles("):
            assert call in src, call
    for text in (razor, island, ring):
        assert "__dp4a" not in text and "fmaf(av" not in text
        assert "tile_products.cuh" not in text
    assert "fmaf(" not in island + ring
    for name in ("systolic_mac", "quant_rows", "razor_matmul",
                 "precision_island", "wkv6", "ssd_chunk", "abft_checksums"):
        assert f'extern "C" int {name}_launch' in texts[f"{name}.cu"]
    # the guard's checksums and verdict: float64 sums in a fixed order (one
    # launch each; the last block of a group adds the partials in block
    # order), no float atomics: integer tickets only, and no per-row
    # shuffle tree
    abft = texts["abft_checksums.cu"]
    for kernel in ("abft_checksums_kernel", "abft_verdict_kernel"):
        assert kernel in abft
    assert 'extern "C" int abft_verdict_launch' in abft
    atomics = re.findall(r"(atomic\w*)\(\s*([^,]+)", abft)
    assert atomics and all(op == "atomicInc" and "ticket" in arg
                           for op, arg in atomics), atomics
    assert "unsigned* tickets" in abft and "unsigned* ticket" in abft
    assert "__shfl_xor_sync" not in abft and "double" in abft
    assert "cp.async.cg.shared.global" in abft
    # the recurrences: accurate expf (no __expf), the Pallas kernels'
    # clamps; wkv6's and ssd_chunk's four products on the TF32 tensor cores
    # with a 3xTF32 split (hi = rna(a), lo = rna(a - hi), by cvt.rna.tf32's
    # rounding rule in integer operations; three products a k-step) and no
    # float atomics
    tf32 = texts["tf32_tiles.cuh"]
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in tf32
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in tf32
    assert "hi = to_tf32(x);" in tf32
    assert "lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));" in tf32
    assert tf32.count("mma_tf32(acc[si][jj], ") == 3
    for name, clamp in (("wkv6.cu", "60.0f"), ("ssd_chunk.cu", "30.0f"),
                        ("wkv6_bwd.cu", "60.0f"),
                        ("ssd_chunk_bwd.cu", "30.0f")):
        src = texts[name]
        assert "expf" in src
        assert "__expf" not in src + tf32
        assert f"EXP_CLAMP = {clamp}" in src
        assert '#include "tf32_tiles.cuh"' in src
        assert "product_3xtf32(" in src
        for text in (src, tf32):
            assert "atomicAdd(" not in text and "atomicCAS(" not in text
    # wkv6's one-token (decode) kernel beside its three passes
    for kernel in ("wkv6_state_kernel", "wkv6_carry_kernel",
                   "wkv6_scan_kernel", "wkv6_token_kernel"):
        assert kernel in texts["wkv6.cu"]
    assert "fmaf" not in texts["wkv6.cu"]
    # their gradients: one C launcher each, no atomics of any kind (the
    # sums over rows, batch and heads are per-block partials added in order)
    for name in ("wkv6_bwd", "ssd_chunk_bwd"):
        assert f'extern "C" int {name}_launch' in texts[f"{name}.cu"]
        assert not re.findall(r"atomic\w*\(", texts[f"{name}.cu"])
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


@pytest.mark.parametrize("kernel", ["razor_matmul", "precision_island",
                                    "wkv6", "ssd_chunk", "wkv6_chunked",
                                    "abft_checksums", "abft_verdict"])
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
    monkeypatch.setattr(wkv6_mod, "wkv6_plain", plain)
    monkeypatch.setattr(ssd_mod, "ssd_chunk_plain", plain)
    monkeypatch.setattr(abft_mod, "abft_checksums_plain", plain)
    monkeypatch.setattr(abft_mod, "abft_verdict_plain", plain)

    def cuda(*shape):
        return torch.zeros(*shape).as_subclass(_CudaLooking)

    a, b = cuda(256, 64), cuda(64, 256)
    seq = cuda(2, 8, 2, 16)
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        if kernel == "razor_matmul":
            razor_mod.razor_matmul(a, b)
        elif kernel == "precision_island":
            tiers = torch.zeros(2, 2, dtype=torch.int32).as_subclass(
                _CudaLooking)
            island_mod.precision_island(a, b, tiers)
        elif kernel == "wkv6":
            wkv6_mod.wkv6(seq, seq, seq, seq, cuda(2, 16), cuda(2, 2, 16, 16))
        elif kernel == "abft_checksums":
            f64 = lambda *s: torch.zeros(*s, dtype=torch.float64) \
                .as_subclass(_CudaLooking)               # noqa: E731
            abft_mod.abft_checksums(b, f64(256, 1), f64(2, 64), abs_rows=1)
        elif kernel == "abft_verdict":
            abft_mod.abft_verdict(a[:4], torch.zeros(
                2, 4 + 64, dtype=torch.float64).as_subclass(_CudaLooking))
        elif kernel == "ssd_chunk":
            ssd_mod.ssd_chunk(seq, cuda(2, 8, 2), cuda(2), cuda(2, 8, 4),
                              cuda(2, 8, 4), cuda(2), cuda(2, 2, 4, 16))
        else:                                  # the model's chunked form
            ssm_mod.wkv6_chunked(seq, seq, seq, seq, cuda(2, 16),
                                 cuda(2, 2, 16, 16), 4)
    assert razor_mod.razor_matmul.launches == 0
    assert island_mod.precision_island.launches == 0
    assert wkv6_mod.wkv6.launches == ssd_mod.ssd_chunk.launches == 0
    assert abft_mod.abft_checksums.launches == 0
    assert abft_mod.abft_verdict.launches == 0


def test_chip_smoke_fails_here_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke run would pass")
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert done.returncode != 0
    assert '"ok"' not in done.stdout and "needs a GPU" in done.stderr
