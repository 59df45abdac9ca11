"""Gradient compression (QSGD-style int8): per-tensor absmax int8 quantize
then dequantize, applied before the optimizer (the numerics-only mode of the
JAX package's train step).

``torch.round`` rounds half to even, as ``jnp.round`` does. The wire format
(``compressed_psum``, an int8 all-gather) waits for the multi-device slice.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale).to(x.dtype)


def quantize_dequantize_tree(tree):
    return tree_map(quantize_dequantize, tree)
