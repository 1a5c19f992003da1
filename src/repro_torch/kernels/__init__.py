"""Hand-written CUDA kernels (the statevector kernels and flash attention),
their plain PyTorch versions, and the wrappers that pick between them by
the device of their inputs."""
