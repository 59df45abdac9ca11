"""Primitive layers: RMSNorm, RoPE, SwiGLU — plain torch, dtype-aware.

Each keeps the rounding points of the JAX package's version, so the two agree
to the last bit in float32 and within rounding in bfloat16.
"""
from __future__ import annotations

import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum`` does
    (float32 activations against bfloat16 weights compute in float32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the variance accumulates in float32; the square, the scale
    and the ``(1 + w)`` product stay in the input dtype."""
    dtype = x.dtype
    var = torch.square(x).to(torch.float32).mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(dtype)
    return x * scale * (1.0 + weight.to(dtype))


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    """(d_head/2,) inverse frequencies, float32."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding.

    x: (..., seq, n_heads, d_head); positions: (..., seq) integer.
    Angles are float32; the rotation multiplies in the input dtype.
    """
    d_head = x.shape[-1]
    inv_freq = rope_frequencies(d_head, theta, x.device)
    angles = positions[..., None].to(torch.float32) * inv_freq  # (..., seq, d/2)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # (..., seq, 1, d/2)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: down( silu(x@gate) * (x@up) )."""
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return matmul(h, w_down)
