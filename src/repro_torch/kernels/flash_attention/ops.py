"""Wrapper of the flash_attention kernels (csrc/flash_attention.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches a
kernel, or raises for what the kernels do not take. The kernel is chosen by
dtype and head dim, never because another one failed:

* ``wgmma``: bfloat16/float16 with d in {64, 128} (every model the port
  runs): TMA loads into a ring of stages, wgmma products, warp-specialised;
* ``mma_sync``: bfloat16/float16 with d in {16, 32}, which the wgmma tiles
  do not take: mma.sync m16n8k16 tiles;
* ``cuda_core_f32``: float32, any d that is a multiple of 4 up to 128.

``launches`` counts every launch, ``launches_by_variant`` each kernel's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# the C launcher's variant codes
VARIANTS = {"cuda_core_f32": 0, "mma_sync": 1, "wgmma": 2}
WGMMA_HEAD_DIMS = (64, 128)
MMA_SYNC_HEAD_DIMS = (16, 32)

launches = 0  # kernel launches since the count was last set to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def variant_for(dtype: torch.dtype, d: int) -> str:
    """The kernel that runs a CUDA call of this dtype and head dim."""
    if dtype == torch.float32:
        return "cuda_core_f32"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma_sync"


def _strides(t: torch.Tensor, name: str, align: int):
    """(batch, head, position) strides in elements; the head dim must be
    contiguous and each row start on a 16-byte boundary."""
    if t.stride(3) != 1 or any(st % align for st in t.stride()[:3]):
        raise ValueError(f"{name}: strides {t.stride()} do not give contiguous, "
                         f"16-byte aligned rows")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes 16-byte aligned tensors only")
    return t.stride()[:3]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention.

    q: (b, n_q, s_q, d); k/v: (b, n_kv, s_k, d), all of one float dtype; any
    strides with a contiguous head dim (a (b, s, n, d) tensor's
    ``transpose(1, 2)`` is taken as is). Query i sits at position
    ``q_offset + i``. Returns (b, n_q, s_q, d) in q's dtype, laid out with
    q's strides."""
    global launches
    if B.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.dtype not in B.FLOAT_TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, n_q, s_q, d = q.shape
    _, n_kv, s_k, dk = k.shape
    f32 = q.dtype == torch.float32
    variant = variant_for(q.dtype, d)
    if (k.shape[0] != b or dk != d or n_kv < 1 or n_q % n_kv or s_q < 1 or s_k < 1
            or window < 0 or q_offset < 0
            or (d % 4 or d > B.MAX_HEAD_DIM if f32
                else d not in WGMMA_HEAD_DIMS + MMA_SYNC_HEAD_DIMS)):
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} window {window} q_offset {q_offset}")
    align = 4 if f32 else 8
    out = torch.empty_like(q)  # q's strides: (b, s, n, d) storage stays so
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n_q, n_kv, s_q, s_k, d, int(causal), int(window), int(q_offset)]
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        args += _strides(t, name, align)
    rc = B.library().ckv_flash_attention(*args, B.dtype_code(q), VARIANTS[variant],
                                         B.stream_handle(q))
    B.check(rc, f"flash_attention {variant}")
    launches += 1
    launches_by_variant[variant] += 1
    return out
