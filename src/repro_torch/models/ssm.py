"""Mamba-1 block (falcon-mamba / hymba SSM heads) over the selective_scan kernel.

Prefill and the per-token decode step both run the recurrence through
``kernels.selective_scan``: on the card that launches the CUDA kernel, on the
CPU it runs the kernel's plain version. Under grad mode, with inputs that
require grad (training), ``mamba_block`` calls ``SelectiveScanFn`` instead on
both devices: on the card the forward kernel that also saves its chunk
carries and the backward kernel, on the CPU the plain forward and backward.
Decode and prefill without grad call the wrapper as before. The rounding
points follow the JAX package's block: the depthwise conv and the projections
in the model dtype, softplus in float32, prefill's dt rounded to the model
dtype before the scan, decode's dt kept in float32. The scan runs in float32:
``mamba_block`` refuses a config whose ``ssm_scan_dtype`` asks for another
(the JAX block's bfloat16 scan elements are not ported); the decode step,
like the JAX one, does not read the field.

Each mixer is two halves around the sum of ``w_x``'s partial products
(:func:`mamba_in` / :func:`mamba_out`, :func:`mamba_decode_in` /
:func:`mamba_decode_out`), so that a tensor-parallel layer
(``launch/tp_compute.py``) runs them on each shard's slice of the d_inner
channels and sums the x_proj partials over the shards between them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan.ops import SelectiveScanFn, selective_scan
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


def check_scan_dtype(cfg) -> None:
    """Raise ValueError where ``cfg.ssm_scan_dtype`` is not "float32": the
    scan runs in float32 only."""
    if cfg.ssm_scan_dtype != "float32":
        raise ValueError(
            f"mamba_block: ssm_scan_dtype {cfg.ssm_scan_dtype!r} is not supported: the scan "
            "runs in float32, and the JAX block's bfloat16 scan is not ported")


def mamba_in(x: torch.Tensor, p: dict):
    """The mixer up to the scan over p's channels (all of them, or a tensor
    shard's slice: ``w_in``'s x and z columns of the slice side by side,
    ``conv_w`` / ``conv_b`` / ``w_x``'s rows of it). x: (b, s, d_model) ->
    (xi, z, the padded raw input xpad (b, s + k - 1, d_in'), the x_proj
    partial (b, s, 2n + 1): B, C and dt over the slice's channels, which a
    sharded layer sums over its shards before :func:`mamba_out`)."""
    s = x.shape[1]
    d_in = p["w_in"].shape[1] // 2
    xz = matmul(x, p["w_in"])  # (b, s, 2 * d_in)
    xi_raw, z = xz[..., :d_in], xz[..., d_in:]
    k = p["conv_w"].shape[0]
    xpad = F.pad(xi_raw, (0, 0, k - 1, 0))  # (b, s + k - 1, d_in)
    xi = _silu(_conv([xpad[:, i: i + s] for i in range(k)], p["conv_w"], p["conv_b"],
                     x.dtype))
    return xi, z, xpad, matmul(xi, p["w_x"])  # x_proj: B, C, dt (dt_rank 1)


def mamba_out(xi: torch.Tensor, z: torch.Tensor, proj: torch.Tensor, p: dict, cfg):
    """The scan over xi's channels with the summed x_proj ``proj``, then D,
    the gate and ``w_out``: (out (b, s, d_model), a partial sum where p's
    channels are a shard's, h_final (b, d_in', n) float32)."""
    n = cfg.ssm_state
    Bv, Cv, dt_raw = proj[..., :n], proj[..., n: 2 * n], proj[..., 2 * n:]
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"]).to(xi.dtype)
    A = -torch.exp(p["A_log"].to(torch.float32))  # (d_in, n)
    args = (xi, dt[..., 0], A, Bv, Cv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y, h_final = SelectiveScanFn.apply(*args)
    else:
        y, h_final = selective_scan(*args)
    y = y + xi.to(torch.float32) * p["D"].to(torch.float32)
    y = y.to(xi.dtype) * _silu(z)
    return matmul(y, p["w_out"]), h_final


def mamba_block(x: torch.Tensor, p: dict, cfg, *, return_state: bool = False):
    """Full mamba-1 mixer. x: (b, s, d_model) -> (b, s, d_model)[, state].

    The state is (h_final (b, d_in, n) float32, conv window (b, k - 1, d_in)):
    the window holds the last k - 1 raw inputs before the conv, with the
    leading zeros of the padding when s < k - 1. Raises ValueError, before
    any work, where ``cfg.ssm_scan_dtype`` is not "float32"."""
    check_scan_dtype(cfg)
    s = x.shape[1]
    xi, z, xpad, proj = mamba_in(x, p)
    out, h_final = mamba_out(xi, z, proj, p, cfg)
    if return_state:
        k = p["conv_w"].shape[0]
        return out, (h_final, xpad[:, s: s + k - 1].contiguous())
    return out


def mamba_decode_in(x: torch.Tensor, conv_buf: torch.Tensor, p: dict):
    """The decode step up to the scan, over p's channels (as
    :func:`mamba_in`): x (b, 1, d_model), conv_buf (b, k - 1, d_in') ->
    (xc (b, d_in'), z (b, 1, d_in'), the new conv window, the x_proj partial
    (b, 2n + 1))."""
    d_in = p["w_in"].shape[1] // 2
    xz = matmul(x, p["w_in"])
    xi, z = xz[..., :d_in], xz[..., d_in:]  # (b, 1, d_in)
    win = torch.cat([conv_buf, xi], dim=1)  # (b, k, d_in)
    xc = _silu(_conv(win.unbind(1), p["conv_w"], p["conv_b"], x.dtype))  # (b, d_in)
    return xc, z, win[:, 1:], matmul(xc, p["w_x"])


def mamba_decode_out(xc: torch.Tensor, z: torch.Tensor, proj: torch.Tensor, h: torch.Tensor,
                     p: dict, cfg):
    """The decode step's scan (``selective_scan`` at s = 1, seeded with the
    carried h) with the summed x_proj, then D, the gate and ``w_out``: (out
    (b, 1, d_model), a partial sum where p's channels are a shard's, h)."""
    n = cfg.ssm_state
    Bv, Cv, dt_raw = proj[:, :n], proj[:, n: 2 * n], proj[:, 2 * n:]
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (b, 1) float32
    A = -torch.exp(p["A_log"].to(torch.float32))
    y1, h = selective_scan(xc[:, None], dt, A, Bv[:, None], Cv[:, None], h)
    y = y1[:, 0] + xc.to(torch.float32) * p["D"].to(torch.float32)
    y = y.to(xc.dtype) * _silu(z[:, 0])
    return matmul(y, p["w_out"])[:, None], h


def mamba_decode_step(
    x: torch.Tensor,  # (b, 1, d_model)
    state: Tuple[torch.Tensor, torch.Tensor],  # (h (b, d_in, n), conv window (b, k-1, d_in))
    p: dict,
    cfg,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """O(1) recurrent decode step: the single-position update runs through
    ``selective_scan`` at s = 1, seeded with the carried state ``h``."""
    h, conv_buf = state
    xc, z, new_buf, proj = mamba_decode_in(x, conv_buf, p)
    out, h = mamba_decode_out(xc, z, proj, h, p, cfg)
    return out, (h, new_buf)


def init_mamba_params(cfg, make, dtype, layers: int) -> dict:
    """Random mixer weights with the JAX package's shapes, scales and dtypes,
    stacked over ``layers``; each layer is drawn in float32 and cast into
    its slot. ``make``: the ``models.common.Leaves`` that places them."""
    d, d_in, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    at = ("layers", "mamba")

    def stacked(name, shape, std):
        return make.stacked(at + (name,), layers, shape, std, dtype)

    def const(name, fn):
        return make.const(at + (name,), fn)

    a_log = const("A_log", lambda dev: torch.log(torch.arange(
        1, n + 1, dtype=torch.float32, device=dev)).expand(layers, d_in, n).contiguous())
    return {
        "w_in": stacked("w_in", (d, 2 * d_in), d ** -0.5),
        "conv_w": stacked("conv_w", (k, d_in), 0.1),
        "conv_b": const("conv_b", lambda dev: torch.zeros((layers, d_in), dtype=dtype,
                                                          device=dev)),
        "w_x": stacked("w_x", (d_in, 2 * n + 1), d_in ** -0.5),
        "dt_bias": const("dt_bias", lambda dev: torch.zeros((layers, 1), dtype=torch.float32,
                                                            device=dev)),
        "A_log": a_log,
        "D": const("D", lambda dev: torch.ones((layers, d_in), dtype=torch.float32, device=dev)),
        "w_out": stacked("w_out", (d_in, d), d_in ** -0.5),
    }


def init_mamba_state(batch: int, cfg, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
    )
