"""Hand-written Hopper kernels of the port, each beside its plain-PyTorch
version (checked against the ``ref.py`` oracles and, through them, against
the Pallas kernels of ``repro.kernels``):

systolic_mac      voltage-island partitioned matmul + Razor flags (the paper)
ops               wrappers + the composed voltage_scaled_matmul flow

razor_matmul, precision_island, wkv6 and ssd_chunk are not ported yet.
"""

from . import ref
from .ops import systolic_matmul, voltage_scaled_matmul

__all__ = ["ref", "systolic_matmul", "voltage_scaled_matmul"]
