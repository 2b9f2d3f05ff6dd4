"""PyTorch/CUDA port of ``imagefolder_tpu`` for one NVIDIA H100.

Mirrors the JAX package's layout and names. The port imports torch and
numpy only; the JAX package is its reference in the tests. Kernels under
``csrc/`` are built with nvcc at their first CUDA call (``ops/cuda/_build.py``).
"""
