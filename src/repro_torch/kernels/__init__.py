"""Hand-written Hopper kernels of the port, one subpackage per kernel
of ``repro.kernels``: the CUDA source, its build, the wrapper and the
plain PyTorch version the CPU tests use."""
