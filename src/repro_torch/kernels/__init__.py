"""Hand-written Hopper kernels of the port, each beside its plain-PyTorch
version (checked against the ``ref.py`` oracles and, through them, against
the Pallas kernels of ``repro.kernels``):

systolic_mac      voltage-island partitioned matmul + Razor flags (the paper)
razor_matmul      int8 main path + f32 shadow, per-cell mismatch correction
precision_island  per-cell int4/int8/f32 tiers (voltage ladder analogue)
quant_rows        the per-row quantization prologue of the two above
ops               wrappers + the composed voltage_scaled_matmul flow

wkv6 and ssd_chunk are not ported yet (ROADMAP.md queue B).
"""

from . import ref
from .ops import precision_mm, razor_mm, systolic_matmul, voltage_scaled_matmul

__all__ = ["ref", "precision_mm", "razor_mm", "systolic_matmul",
           "voltage_scaled_matmul"]
