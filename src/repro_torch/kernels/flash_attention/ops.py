"""Wrapper of the flash_attention kernels (csrc/flash_attention.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches a
kernel, or raises for what the kernels do not take. The kernel is chosen by
dtype and head dim, never because another one failed:

* ``wgmma``: bfloat16/float16 with d in {64, 128, 256} (every model the
  port runs; 256: gemma3-4b's heads): TMA loads into a ring of stages,
  wgmma products; it also writes the logsumexp its backward reads;
* ``mma_sync``: bfloat16/float16 with d in {16, 32}, which the 128-byte
  swizzled tiles do not take: mma.sync m16n8k16 tiles;
* ``cuda_core_f32``: float32, any d that is a multiple of 4 up to 256.

``launches`` counts every launch, ``launches_by_variant`` each kernel's.

Meta tensors (the dry run, ``launch/dryrun.py``) take the CUDA route's
checks and get its outputs' shapes, dtypes and strides, uninitialised. Such
a call launches nothing, counts in none of the counters here and runs no
plain version, whose s x s scores the kernel never holds: it reports the
variant the card would run and the kernel's work (``kernels/work.py``) to
the active recorder, as a CUDA launch does.

The backward (csrc/flash_attention_bwd.cu, no atomics) takes float32,
bfloat16 and float16 at d in {16, 32, 64, 128}, and bfloat16 and float16 at
d 256; its variant is chosen by dtype and head dim (``bwd_variant_for``):

* ``wgmma``: bfloat16/float16 with d in {64, 128, 256}: a preprocess kernel
  (D), then a dK/dV and a dQ kernel on wgmma with TMA-fed stages, reading
  the logsumexp the wgmma forward saved (``lse``, log2 units); at d 256 the
  dK/dV kernel's two warpgroups own dV and dK (never both);
* ``cuda_core_f32``: float32 (d up to 128), and 16-bit at d 16 / 32: a
  stats pass, a dK/dV pass and a dQ pass in float32 on the CUDA cores.

float32 at d 256 has no backward kernel and raises: the card trains in
bfloat16, and CPU tensors run the plain version.

``flash_attention_bwd`` launches it and ``FlashAttentionFn`` puts the
forward and the backward under autograd. ``bwd_launches`` counts its calls,
``bwd_launches_by_variant`` each variant's, ``dout_copies`` the output
gradients it had to copy into a layout the kernel reads. The forward wrapper
itself refuses inputs that require grad under grad mode: its output has no
graph.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels import work as W
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

# the C launchers' variant codes
VARIANTS = {"cuda_core_f32": 0, "mma_sync": 1, "wgmma": 2}
BWD_VARIANTS = ("cuda_core_f32", "wgmma")
# the backward variants that read the logsumexp their forward wrote
LSE_VARIANTS = ("wgmma",)
WGMMA_HEAD_DIMS = (64, 128, 256)
MMA_SYNC_HEAD_DIMS = (16, 32)
# rows of the logsumexp buffer: s_q rounded up to the 128-row CTAs of the
# wgmma kernels, so each 64-row stage of it is one aligned copy
LSE_ROW_ALIGN = 128

launches = 0  # kernel launches since the count was last set to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)  # 256: 16-bit only (the wgmma variant)
bwd_launches = 0  # backward calls since the count was last set to 0
bwd_launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
dout_copies = 0  # output gradients copied into a layout the backward reads


def variant_for(dtype: torch.dtype, d: int) -> str:
    """The kernel that runs a CUDA call of this dtype and head dim."""
    if dtype == torch.float32:
        return "cuda_core_f32"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma_sync"


def bwd_variant_for(dtype: torch.dtype, d: int) -> str:
    """The backward kernels that run a CUDA call of this dtype and head dim:
    wgmma where the forward runs wgmma (it reads the logsumexp that forward
    saves), cuda_core_f32 otherwise."""
    return "wgmma" if variant_for(dtype, d) == "wgmma" else "cuda_core_f32"


def writes_lse(dtype: torch.dtype, d: int) -> bool:
    """Whether the forward kernel of this dtype and head dim can write the
    logsumexp (``flash_attention(..., lse=)``): the ones whose backward
    reads it."""
    return bwd_variant_for(dtype, d) in LSE_VARIANTS


def lse_buffer(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised float32 (b, n_q, s_q rounded up to LSE_ROW_ALIGN)
    buffer for the logsumexp of ``flash_attention(..., lse=...)``."""
    b, n_q, s_q = q.shape[:3]
    rows = -(-s_q // LSE_ROW_ALIGN) * LSE_ROW_ALIGN
    return torch.empty((b, n_q, rows), dtype=torch.float32, device=q.device)


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    b, n_q, s_q = q.shape[:3]
    if (lse.dtype != torch.float32 or lse.device != q.device or lse.dim() != 3
            or tuple(lse.shape[:2]) != (b, n_q) or lse.shape[2] < s_q
            or lse.shape[2] % LSE_ROW_ALIGN or not lse.is_contiguous()):
        raise ValueError(f"lse: {tuple(lse.shape)} {lse.dtype} on {lse.device} is not a "
                         f"lse_buffer for q {tuple(q.shape)}")


def _rows_aligned(t: torch.Tensor, align: int) -> bool:
    return (t.stride(3) == 1 and not any(st % align for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _strides(t: torch.Tensor, name: str, align: int):
    """(batch, head, position) strides in elements; the head dim must be
    contiguous and each row start on a 16-byte boundary."""
    if not _rows_aligned(t, align):
        raise ValueError(f"{name}: strides {t.stride()} (at offset {t.data_ptr() % 16} of 16 "
                         f"bytes) do not give contiguous, 16-byte aligned rows")
    return t.stride()[:3]


def _shapes(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int, q_offset: int,
            **extra) -> dict:
    """A call's shapes as ``work.kernel_work`` takes them."""
    b, n_q, s_q, d = q.shape
    return dict(b=b, n_q=n_q, n_kv=k.shape[1], s_q=s_q, s_k=k.shape[2], d=d,
                itemsize=q.element_size(), causal=bool(causal), window=int(window),
                q_offset=int(q_offset), **extra)


@B.on_own_device
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention.

    q: (b, n_q, s_q, d); k/v: (b, n_kv, s_k, d), all of one float dtype; any
    strides with a contiguous head dim (a (b, s, n, d) tensor's
    ``transpose(1, 2)`` is taken as is). Query i sits at position
    ``q_offset + i``. Returns (b, n_q, s_q, d) in q's dtype, laid out with
    q's strides.

    ``lse`` (CUDA, the wgmma variant: ``writes_lse``):
    a ``lse_buffer(q)`` that the kernel fills with each query row's
    logsumexp in log2 units of the scaled scores
    (``flash_attention_lse_ref``'s), for the backward; the output is the
    same bits with or without it."""
    global launches
    where = B.route(q, k, v)
    if where == "cpu":
        if lse is not None:
            raise ValueError("flash_attention: lse is written by the CUDA kernels only")
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    B.refuse_grad("flash_attention (use FlashAttentionFn to train)", q, k, v)
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
    if lse is not None:
        if not writes_lse(q.dtype, d):
            raise ValueError(f"flash_attention: the {variant} kernel writes no lse at d {d}")
        _check_lse(lse, q)
    align = 4 if f32 else 8
    out = torch.empty_like(q)  # q's strides: (b, s, n, d) storage stays so
    strides = [st for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
               for st in _strides(t, name, align)]
    recorder = W.active()
    if recorder is not None:
        recorder.add_kernel("flash_attention", variant, **_shapes(
            q, k, causal, window, q_offset, lse_rows=0 if lse is None else lse.shape[2]))
    if where == "cuda":
        rc = B.library().ckv_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n_q, n_kv, s_q, s_k, d, int(causal), int(window), int(q_offset), *strides,
            None if lse is None else lse.data_ptr(), 0 if lse is None else lse.shape[2],
            B.dtype_code(q), VARIANTS[variant], B.stream_handle(q))
        B.check(rc, f"flash_attention {variant}")
        launches += 1
        launches_by_variant[variant] += 1
    return out


def _check_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
               q_offset: int) -> None:
    """Raise for a CUDA call the backward kernel does not take."""
    if q.dtype not in B.FLOAT_TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, n_q, s_q, d = q.shape
    _, n_kv, s_k, dk = k.shape
    if (k.shape[0] != b or dk != d or d not in BWD_HEAD_DIMS or n_kv < 1 or n_q % n_kv
            or s_q < 1 or s_k < 1 or window < 0 or q_offset < 0):
        raise ValueError(f"flash_attention_bwd: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} window {window} q_offset {q_offset} (head dims "
                         f"{BWD_HEAD_DIMS})")
    if d == 256 and q.dtype == torch.float32:
        raise ValueError("flash_attention_bwd: float32 at d 256 has no backward kernel (the "
                         "d-256 backward is wgmma, bfloat16/float16 only); train in "
                         "bfloat16, or on CPU tensors, which run the plain version")


@B.on_own_device
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, lse: torch.Tensor | None = None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)`` at
    output ``out`` for the output gradient ``dout``.

    Shapes and strides as ``flash_attention`` takes them (out and dout like
    q); each gradient has its input's dtype and, for a dense input, its
    strides. A ``dout`` whose rows the kernel cannot read in place (not
    16-byte aligned, or a head dim that is not contiguous) is copied once
    into a fresh contiguous tensor and counted in ``dout_copies``.

    ``lse``: the wgmma variant's input, the logsumexp its forward wrote
    (``FlashAttentionFn`` passes the one it saved); it raises without it.
    The cuda_core_f32 variant takes none: its stats pass computes its own."""
    global bwd_launches, dout_copies
    where = B.route(q, k, v, out, dout)
    if where == "cpu":
        if lse is not None:
            raise ValueError("flash_attention_bwd: lse is read by the CUDA kernels only")
        return flash_attention_bwd_ref(q, k, v, out, dout, causal=causal, window=window,
                                       q_offset=q_offset)
    _check_bwd(q, k, v, window, q_offset)
    if out.shape != q.shape or dout.shape != q.shape or {out.dtype, dout.dtype} != {q.dtype}:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} {out.dtype}, dout "
                         f"{tuple(dout.shape)} {dout.dtype} against q {tuple(q.shape)} {q.dtype}")
    b, n_q, s_q, d = q.shape
    n_kv, s_k = k.shape[1], k.shape[2]
    variant = bwd_variant_for(q.dtype, d)
    if variant in LSE_VARIANTS:
        if lse is None:
            raise ValueError(f"flash_attention_bwd: the {variant} kernels read the lse that "
                             "flash_attention(..., lse=lse_buffer(q)) wrote; none was given")
        _check_lse(lse, q)
    elif lse is not None:
        raise ValueError(f"flash_attention_bwd: the {variant} kernels read no lse")
    else:
        lse = lse_buffer(q)  # scratch of the stats pass
    align = 4 if q.dtype == torch.float32 else 8
    if not _rows_aligned(dout, align):
        # a fresh allocation: .contiguous() would hand back a contiguous tensor
        # that starts off a 16-byte boundary as it is
        dout = dout.clone(memory_format=torch.contiguous_format)
        if where == "cuda":
            dout_copies += 1
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tensors = (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout), ("dq", dq),
               ("dk", dk), ("dv", dv))
    strides = [st for name, t in tensors for st in _strides(t, name, align)]
    dsum = torch.empty_like(lse)  # the kernels' scratch (D)
    recorder = W.active()
    if recorder is not None:
        recorder.add_kernel("flash_attention_bwd", variant,
                            **_shapes(q, k, causal, window, q_offset))
    if where == "cuda":
        rc = B.library().ckv_flash_attention_bwd(
            *(t.data_ptr() for _, t in tensors), lse.data_ptr(), dsum.data_ptr(),
            b, n_q, n_kv, s_q, s_k, d, int(causal), int(window), int(q_offset), lse.shape[2],
            (ctypes.c_longlong * 24)(*strides), B.dtype_code(q), VARIANTS[variant],
            B.stream_handle(q))
        B.check(rc, f"flash_attention_bwd {variant}")
        bwd_launches += 1
        bwd_launches_by_variant[variant] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward kernel, then the
    backward kernels (``flash_attention_bwd``) for the gradients of q, k and
    v. Saves q, k, v, the output and, where the backward's variant reads one
    (wgmma), the logsumexp the forward wrote. On CPU tensors both are the plain
    versions; on meta tensors both take their meta routes. A CUDA call the
    backward does not take raises here, before the forward runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window: int = 0, q_offset: int = 0):
        lse = None
        if B.route(q, k, v) != "cpu":
            _check_bwd(q, k, v, window, q_offset)
            if writes_lse(q.dtype, q.shape[-1]):
                lse = lse_buffer(q)
        out = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, causal=causal, window=window,
                                         q_offset=q_offset, lse=lse)
        return dq, dk, dv, None, None, None
