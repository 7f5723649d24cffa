"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (the CPU path and the kernel's reference on the card)."""
