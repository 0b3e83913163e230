"""Architecture registry: ``--arch <id>`` resolves here."""

from typing import Callable, Dict, Tuple

from . import (granite_20b, grok_1_314b, llama4_scout_17b_a16e,
               llava_next_mistral_7b, phi4_mini_3_8b, qwen1_5_110b,
               rwkv6_1_6b, seamless_m4t_medium, starcoder2_3b, zamba2_2_7b)
from .base import (SHAPES, ModelConfig, ShapeConfig, cell_is_runnable,
                   pad_vocab)

_MODULES = {
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "grok-1-314b": grok_1_314b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "granite-20b": granite_20b,
    "qwen1.5-110b": qwen1_5_110b,
    "starcoder2-3b": starcoder2_3b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "zamba2-2.7b": zamba2_2_7b,
    "rwkv6-1.6b": rwkv6_1_6b,
}

ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE: Dict[str, Callable[[], ModelConfig]] = {
    k: m.smoke_config for k, m in _MODULES.items()}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return SMOKE[arch]() if smoke else ARCHS[arch]


def all_cells():
    """Every (arch, shape) pair with its runnability verdict — 40 cells."""
    for arch, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            ok, why = cell_is_runnable(cfg, shape)
            yield arch, sname, ok, why


__all__ = ["ARCHS", "SMOKE", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "all_cells", "cell_is_runnable", "pad_vocab"]
