"""PyTorch/CUDA port of the scanner's device program, for NVIDIA Hopper.

The JAX package (``rtl_sdr_scanner_tpu``) is the reference; this package
keeps its module layout and names so every function has a findable
counterpart, and imports nothing of it (nor JAX). Kernels that the JAX
package wrote in Pallas are hand-written CUDA C++ under ``csrc/``, built
with ``nvcc`` on first use (``ops/cuda/build.py``); on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.

Importing this package builds nothing and touches no CUDA state.
"""

from rtl_sdr_scanner_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
