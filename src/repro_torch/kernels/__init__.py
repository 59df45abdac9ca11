"""Hand-written CUDA kernels for Hopper, one package each.

Each kernel package holds ``ops.py`` (the wrapper: the plain version for a
CPU tensor, the kernel for a CUDA tensor) and ``ref.py`` (the plain PyTorch
version of the same function). The CUDA sources live in ``repro_torch/csrc``
and are built by :mod:`repro_torch.kernels.build` at first use.
"""
