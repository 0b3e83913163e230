"""repro_torch: the PyTorch/CUDA port of ``repro`` (voltage-scaled
partitioned DNN accelerators, Paul et al., 2021) for NVIDIA Hopper.

Same sub-package and module names as ``repro``; imports ``torch``, ``numpy``
and the standard library only.  Every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
