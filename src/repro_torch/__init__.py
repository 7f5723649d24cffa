"""PyTorch + CUDA port of the wearable full-system model (`repro`).

Mirrors the reference package's layout (`core/`, `kernels/`,
`serving/`, `configs/`, `nn/`, `models/`, `launch/`, `training/`,
`data/`) and imports
neither JAX nor the reference package: modules the port needs are its
own copies, and data it needs travels under `data/`.  Every TPU kernel
of the reference has a hand-written CUDA counterpart for Hopper, built
with nvcc on first use: the twin's day scan (`csrc/day_scan.cu`) and
the language models' flash attention and SSD scan
(`csrc/flash_attention.cu`, `csrc/ssd_scan.cu`).  Training
(`launch/train.py`, `training/`, `data/pipeline.py`) differentiates the
flash kernel through a hand-written backward kernel
(`csrc/flash_attention_bwd.cu`); the kernels without a backward refuse
inputs that require a gradient.

Entry points take `device` (default ``"cuda"``) and raise without a
card; the CPU runs only when asked for (``device="cpu"``), through the
kernels' plain PyTorch versions.
"""
