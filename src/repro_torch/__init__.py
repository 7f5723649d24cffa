"""PyTorch + CUDA port of the wearable full-system model (`repro`).

Mirrors the reference package's layout (`core/`, `kernels/`,
`serving/`) and imports neither JAX nor the reference package: modules
the port needs are its own copies, and data it needs travels under
`data/`.  The day scan of the serving path is a hand-written CUDA
kernel for Hopper (`csrc/day_scan.cu`), built with nvcc on first use.

Entry points take `device` (default ``"cuda"``) and raise without a
card; the CPU runs only when asked for (``device="cpu"``), through the
kernels' plain PyTorch versions.
"""
