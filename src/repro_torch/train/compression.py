"""Gradient compression (QSGD-style int8): per-tensor absmax int8 quantize
then dequantize, applied before the optimizer (the numerics-only mode of the
JAX package's train step), and ``compressed_psum``, the all-reduce whose
wire format is the int8 values and one float32 scale a participant.

``torch.round`` rounds half to even, as ``jnp.round`` does. The train step
(over a mesh or not) calls ``quantize_dequantize_tree``, not
``compressed_psum``, as the JAX package's does.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.tree import tree_map


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax, min=1e-12) / 127.0


def _levels(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)


def _quantize(x: torch.Tensor):
    """(int8 levels, float32 absmax scale) of x."""
    scale = _scale(x.to(torch.float32).abs().max())
    return _levels(x, scale), scale


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    q, scale = _quantize(x)
    return (q.to(torch.float32) * scale).to(x.dtype)


def quantize_dequantize_tree(tree):
    return tree_map(quantize_dequantize, tree)


def quantize_dequantize_blocks(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``quantize_dequantize`` of a leaf held as ``blocks`` (its distinct
    blocks, each once): one absmax scale, the max over the blocks, and each
    block quantized with it; each element the bits the whole leaf's call
    gives it."""
    scale = _scale(torch.stack([b.to(torch.float32).abs().max().to(blocks[0].device)
                                for b in blocks]).max())
    return [(_levels(b, scale.to(b.device)).to(torch.float32) * scale.to(b.device)).to(b.dtype)
            for b in blocks]


def compressed_psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over one mesh axis with int8 on the wire: ``xs`` holds one
    tensor a participant, in the axis's order, each on its participant's
    device. Each participant quantizes its tensor to int8 with its own
    absmax scale; only the int8 values and the float32 scale move to the
    other participants' devices (4x fewer bytes than float32). Each
    participant sums ``q * scale`` in float32 in participant order and
    casts to its tensor's dtype, as the JAX package's all-gather-then-sum
    under ``shard_map`` does. Returns one sum a participant, on its device."""
    wire = [_quantize(x) for x in xs]
    out = []
    for x in xs:
        acc = None
        for q, scale in wire:
            term = q.to(x.device).to(torch.float32) * scale.to(x.device)
            acc = term if acc is None else acc + term
        out.append(acc.to(x.dtype))
    return out
