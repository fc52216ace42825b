"""MegaPortraits in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package ``megaportraits_tpu`` that keeps its layout: the
same module tree (core/, nn/, ops/, models/, infer/, utils/), the same
public tensor layouts (NHWC images, NDHWC volumes, flows as [B,D,H,W,3] in
(x, y, z) order) and the same parameter names, so that the JAX package can
serve as the numerical reference and its weights load through
``utils/jax_bridge.py``. The G2d trunk runs on hand-written CUDA kernels
(``csrc/``, ``ops/kernels/``). This package imports neither JAX nor the
JAX package.
"""
