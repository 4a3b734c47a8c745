"""PyTorch/CUDA port of ``tactilesimulation_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's module names and batch-last layouts. Hand-written
CUDA kernels live in ``csrc/`` and are built with nvcc at first use
(``ops/_build.py``); on CPU tensors every kernel's plain PyTorch version runs
instead. Nothing here imports JAX or the JAX package.
"""
