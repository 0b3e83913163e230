"""Optimizers: AdamW (+ fp32 master, int8 moments, clipping, schedules)."""

from .adamw import (AdamWConfig, Quantized, apply_updates, dequantize_i8,
                    global_norm, init_state, lr_at, quantize_i8, state_specs)

__all__ = [name for name in dir() if not name.startswith("_")]
