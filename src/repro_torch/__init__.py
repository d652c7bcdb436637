"""PyTorch/CUDA port of the BitDecoding system for NVIDIA Hopper (H100).

Mirrors the module layout of the JAX package (``repro``): configs, the packed
low-bit KV cache (``core``), the hand-written CUDA kernels (``kernels``, built
from ``csrc/`` on first use) and the attention-family ``DecoderLM``
(``models``).  Entry points run on the card unless handed CPU tensors or
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.
"""
