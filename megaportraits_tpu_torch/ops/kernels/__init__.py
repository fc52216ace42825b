"""Hand-written Hopper kernels of the port (sources in ``csrc/``).

Each kernel module holds the wrapper (CUDA tensors launch the kernel or
raise; CPU tensors run the plain version), the plain PyTorch version and a
``launches`` counter on the wrapper.
"""
