"""ContiguousKV in PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``repro`` is the reference; this package never imports it.
"""
