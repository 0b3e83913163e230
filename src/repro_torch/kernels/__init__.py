"""Hand-written Hopper kernels of the port, each beside its plain-PyTorch
version (checked against the ``ref.py`` oracles and, through them, against
the Pallas kernels of ``repro.kernels``):

systolic_mac      voltage-island partitioned matmul + Razor flags (the paper)
razor_matmul      int8 main path + f32 shadow, per-cell mismatch correction
precision_island  per-cell int4/int8/f32 tiers (voltage ladder analogue)
quant_rows        the per-row quantization prologue of the two above
wkv6              chunked RWKV6 WKV recurrence (models/ssm.py, rwkv6), and
                  its gradient (csrc/wkv6_bwd.cu)
ssd_chunk         chunked Mamba2 SSD recurrence (models/ssm.py, zamba2),
                  and its gradient (csrc/ssd_chunk_bwd.cu)
ops               wrappers + the composed voltage_scaled_matmul flow
"""

from . import ref
from .ops import (precision_mm, razor_mm, ssd_op, systolic_matmul,
                  voltage_scaled_matmul, wkv6_op)

__all__ = ["ref", "precision_mm", "razor_mm", "ssd_op", "systolic_matmul",
           "voltage_scaled_matmul", "wkv6_op"]
