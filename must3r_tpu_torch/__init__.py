"""MUSt3R on PyTorch and CUDA: the port of ``must3r_tpu`` to one NVIDIA
Hopper GPU.

Plain tensor code is PyTorch; the flash-attention kernels of the
offline-reconstruction and training paths are CUDA C++ written for sm_90a
(``csrc/attention_sm90.cu``, ``csrc/attention_bwd_sm90.cu``), each with a
plain PyTorch version beside it that CPU tensors take. Parameters carry the
reference state-dict key names, and public functions keep the JAX package's
tensor layouts.

This package imports torch, numpy and the standard library, never jax and
nothing of the JAX package: the configs and presets are its own copy
(``must3r_tpu_torch/config.py``).
"""

from must3r_tpu_torch.config import (  # noqa: F401
    DecoderConfig,
    EncoderConfig,
    must3r_224_configs,
    must3r_512_configs,
)
