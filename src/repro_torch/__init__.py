"""PyTorch/CUDA port of the DQuLearn system (``repro``'s counterpart).

Module paths mirror ``repro``'s, so each ported file sits at the same path as
the JAX module it reproduces.  The package imports ``torch``, numpy and the
standard library only; its statevector kernels are hand-written CUDA for
Hopper (``repro_torch/kernels/csrc``), built at first use.  Every entry point
runs on the GPU unless the caller asks for the CPU, where each kernel
wrapper takes its plain PyTorch version instead.
"""
