"""CoDec prefix-shared decoding on PyTorch and CUDA (NVIDIA H100).

The port of the JAX package ``repro``: the same prefix forest, plans and
decode engine, with the TPU's Pallas kernels rewritten as hand-written
CUDA kernels for Hopper (``kernels/csrc``).  It imports neither ``jax``
nor ``repro``.
"""
