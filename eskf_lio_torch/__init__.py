"""ESKF-LIO on PyTorch and CUDA: the port of `eskf_lio_tpu` to one NVIDIA H100.

The JAX package `eskf_lio_tpu/` is the reference; this package mirrors its
layout module for module and imports nothing of it (nor of JAX).  Plain
tensor code is PyTorch; each Pallas kernel of the JAX package is a CUDA C++
kernel written for Hopper (`csrc/`), built with `nvcc` at first use and
bound through `ctypes` (`ops/_cuda.py`).

Layers (bottom-up), as in the JAX package:
  ops/       Lie-group math, voxel keys, sort-merge primitives, deskew,
             downsample + covariances, the two CUDA kernels
  map/       the two-tier hash-ordered voxel map
  models/    error-state Kalman filter, VGICP Gauss-Newton registration
  pipeline/  the per-scan step and the replay driver
  io/        the synthetic sequence generator
  utils/     ATE metrics, state conversion from the JAX package's arrays

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; without a GPU the default raises instead of falling back.
"""

__version__ = "0.1.0"

from eskf_lio_torch.config import Config, load_config

__all__ = ["Config", "load_config", "__version__"]
