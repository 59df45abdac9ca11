"""Mamba-1 block (falcon-mamba / hymba SSM heads) over the selective_scan kernel.

Prefill and the per-token decode step both run the recurrence through
``kernels.selective_scan``: on the card that launches the CUDA kernel, on the
CPU it runs the kernel's plain version. The rounding points follow the JAX
package's block: the depthwise conv and the projections in the model dtype,
softplus in float32, prefill's dt rounded to the model dtype before the scan,
decode's dt kept in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.layers import matmul


def _silu(x: torch.Tensor) -> torch.Tensor:
    """silu in float32, rounded back to x's dtype."""
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv(windows, conv_w: torch.Tensor, conv_b: torch.Tensor, dtype) -> torch.Tensor:
    """Depthwise conv: sum over taps i of windows[i] * conv_w[i], accumulated
    in float32 and rounded once (an einsum over the taps), plus the bias."""
    acc = None
    for i, w in enumerate(windows):
        term = w.to(torch.float32) * conv_w[i].to(torch.float32)
        acc = term if acc is None else acc + term
    return acc.to(dtype) + conv_b


def mamba_block(x: torch.Tensor, p: dict, cfg, *, return_state: bool = False):
    """Full mamba-1 mixer. x: (b, s, d_model) -> (b, s, d_model)[, state].

    The state is (h_final (b, d_in, n) float32, conv window (b, k - 1, d_in)):
    the window holds the last k - 1 raw inputs before the conv, with the
    leading zeros of the padding when s < k - 1."""
    b, s, _ = x.shape
    d_in, n = cfg.d_inner, cfg.ssm_state
    xz = matmul(x, p["w_in"])  # (b, s, 2 * d_in)
    xi_raw, z = xz[..., :d_in], xz[..., d_in:]
    k = p["conv_w"].shape[0]
    xpad = F.pad(xi_raw, (0, 0, k - 1, 0))  # (b, s + k - 1, d_in)
    xi = _silu(_conv([xpad[:, i: i + s] for i in range(k)], p["conv_w"], p["conv_b"],
                     x.dtype))
    proj = matmul(xi, p["w_x"])  # (b, s, 2n + 1): B, C, dt (dt_rank 1)
    Bv, Cv, dt_raw = proj[..., :n], proj[..., n: 2 * n], proj[..., 2 * n:]
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"]).to(x.dtype)
    A = -torch.exp(p["A_log"].to(torch.float32))  # (d_in, n)
    y, h_final = selective_scan(xi, dt[..., 0], A, Bv, Cv)
    y = y + xi.to(torch.float32) * p["D"].to(torch.float32)
    y = y.to(x.dtype) * _silu(z)
    out = matmul(y, p["w_out"])
    if return_state:
        return out, (h_final, xpad[:, s: s + k - 1].contiguous())
    return out


def mamba_decode_step(
    x: torch.Tensor,  # (b, 1, d_model)
    state: Tuple[torch.Tensor, torch.Tensor],  # (h (b, d_in, n), conv window (b, k-1, d_in))
    p: dict,
    cfg,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """O(1) recurrent decode step: the single-position update runs through
    ``selective_scan`` at s = 1, seeded with the carried state ``h``."""
    h, conv_buf = state
    d_in, n = cfg.d_inner, cfg.ssm_state
    xz = matmul(x, p["w_in"])
    xi, z = xz[..., :d_in], xz[..., d_in:]  # (b, 1, d_in)
    win = torch.cat([conv_buf, xi], dim=1)  # (b, k, d_in)
    new_buf = win[:, 1:]
    xc = _silu(_conv(win.unbind(1), p["conv_w"], p["conv_b"], x.dtype))  # (b, d_in)
    proj = matmul(xc, p["w_x"])
    Bv, Cv, dt_raw = proj[:, :n], proj[:, n: 2 * n], proj[:, 2 * n:]
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (b, 1) float32
    A = -torch.exp(p["A_log"].to(torch.float32))
    y1, h = selective_scan(xc[:, None], dt, A, Bv[:, None], Cv[:, None], h)
    y = y1[:, 0] + xc.to(torch.float32) * p["D"].to(torch.float32)
    y = y.to(x.dtype) * _silu(z[:, 0])
    out = matmul(y, p["w_out"])[:, None]
    return out, (h, new_buf)


def init_mamba_params(cfg, generator: torch.Generator, dtype, device, layers: int) -> dict:
    """Random mixer weights with the JAX package's shapes, scales and dtypes,
    stacked over ``layers``; each layer is drawn in float32 and cast into
    its slot."""
    d, d_in, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    f32 = dict(dtype=torch.float32, device=device)

    def stacked(shape, std):
        out = torch.empty((layers,) + shape, dtype=dtype, device=device)
        for l in range(layers):
            out[l] = std * torch.randn(shape, generator=generator, device=device)
        return out

    a_log = torch.log(torch.arange(1, n + 1, **f32)).expand(layers, d_in, n).contiguous()
    return {
        "w_in": stacked((d, 2 * d_in), d ** -0.5),
        "conv_w": stacked((k, d_in), 0.1),
        "conv_b": torch.zeros((layers, d_in), dtype=dtype, device=device),
        "w_x": stacked((d_in, 2 * n + 1), d_in ** -0.5),
        "dt_bias": torch.zeros((layers, 1), **f32),
        "A_log": a_log,
        "D": torch.ones((layers, d_in), **f32),
        "w_out": stacked((d_in, d), d_in ** -0.5),
    }


def init_mamba_state(batch: int, cfg, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
    )
