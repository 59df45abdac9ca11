"""Build the CUDA kernels into one shared library and load it with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are then linked into
``build/kernels/libreprokernels-<hash>.so`` at the repository root, where
``<hash>`` covers the sources and flags, so an edited source is never served
by a stale library. The library has a plain C interface: tensors pass as
device pointers, the stream as a handle, and every launcher returns the
``cudaGetLastError`` code after its launches.

Nothing is built when this module is imported; the first kernel call builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
# C signature of each launcher: argument types in order (restype is int)
SIGNATURES = {
    # q, k, out, work, work_floats, counters, s, n_q, n_kv, n, d, c, q_dtype, stream
    "ckv_chunk_score": [P] * 4 + [L, P] + [I] * 7 + [P],
    # q, k_sel, v_sel, k_suf, v_suf, out, mass, work, work_floats, counters,
    # s, n_q, n_kv, nb, c, n_valid, d, q_dtype, stream
    "ckv_chunk_attention": [P] * 8 + [L, P] + [I] * 8 + [P],
    # q, k_pool, v_pool, k_suf, v_suf, chunk_idx, n_valid, out, mass, work, work_floats,
    # counters, b, s, n_q, n_kv, n_sel, c, d, q_dtype, stream
    "ckv_chunk_attention_indexed": [P] * 10 + [L, P] + [I] * 8 + [P],
    # q, k_pool, v_pool, table, lengths, out, mass, work, work_floats, counters,
    # b, n_q, n_kv, n_pages, page, n_active, d, dtype, stream
    "ckv_decode_attention": [P] * 8 + [L, P] + [I] * 8 + [P],
    # q, pool_ptrs, table, lengths, out, mass, work, work_floats, counters,
    # b, n_q, n_kv, page, n_active, d, dtype, stream
    "ckv_decode_attention_pools": [P] * 7 + [L, P] + [I] * 7 + [P],
    # q, k, v, out, b, n_q, n_kv, s_q, s_k, d, causal, window, q_offset,
    # (batch, head, position) strides of q, k, v and out, dtype, variant, stream
    "ckv_flash_attention": [P] * 4 + [I] * 9 + [L] * 12 + [I, I, P],
    # x, dt, A, B, C, h0, y, h_out, scratch, b, s, d_in, n, B's and C's
    # (batch, position) strides, dtype, variant, stream
    "ckv_selective_scan": [P] * 9 + [I] * 10 + [P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libreprokernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless an up-to-date one exists.

    The compilers' messages (``ptxas -v``: registers, shared memory, spills)
    go to ``build.log`` beside the library."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    # per-process object names: concurrent builders never share a file
    objs = [BUILD_DIR / f"{f.stem}-{lib.stem[-16:]}-{os.getpid()}.o" for f in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs = []
    failed = []
    for src, p in zip(sources, procs):
        out, _ = p.communicate()
        logs.append(f"== {src.name} (rc={p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                          "-o", str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    with open(BUILD_DIR / "build.log", "a") as f:
        f.write(f"\nbuilt {lib.name} in {time.perf_counter() - t0:.1f} s\n")
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with every launcher's argtypes/restype declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ckv_error_string.argtypes = [ctypes.c_int]
    lib.ckv_error_string.restype = ctypes.c_char_p
    # the scratch sizes each kernel's own source computes (-1: not taken)
    for name, n_args in (("ckv_selective_scan_scratch", 4),
                         ("ckv_chunk_score_work_floats", 6),
                         ("ckv_chunk_attention_work_floats", 6),
                         ("ckv_chunk_attention_indexed_work_floats", 7),
                         ("ckv_decode_attention_work_floats", 5)):
        fn = getattr(lib, name)
        fn.argtypes = [I] * n_args
        fn.restype = L
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc != 0:
        msg = library().ckv_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


# dtype codes shared with the C side (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}


def dtype_code(t) -> int:
    name = str(t.dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel does not take dtype {t.dtype}")
    return DTYPE_CODES[name]


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if every one lies on one
    CUDA device; raises for a mix or any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cpu"


def require(t: torch.Tensor, name: str, ndim: int, dtypes) -> None:
    """Raise unless ``t`` has ``ndim`` dims, one of ``dtypes``, is contiguous
    and starts on a 16-byte boundary (the kernels load 16-byte vectors)."""
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors only")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes 16-byte aligned tensors only")


_WORKSPACES = {}


def workspace(name: str, t: torch.Tensor, n_floats: int, n_ints: int):
    """(float32 scratch of at least ``n_floats``, int32 counters of at least
    ``n_ints``) kept for kernel ``name`` on ``t``'s device and current stream.

    Kept from call to call and grown, never shrunk: a launch finds its
    scratch without an allocation, and calls on one stream run in order, so
    none overwrites scratch that an earlier call still reads. The counters
    are zero when made and each launch leaves them zero (``last_to_arrive``
    in csrc/common.cuh)."""
    key = (name, t.device, torch.cuda.current_stream(t.device).cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_ints:
        old = ws or (torch.empty(0), torch.empty(0))
        ws = (torch.empty(max(n_floats, old[0].numel()), dtype=torch.float32, device=t.device),
              torch.zeros(max(n_ints, old[1].numel()), dtype=torch.int32, device=t.device))
        _WORKSPACES[key] = ws
    return ws


FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_HEAD_DIM = 256  # and multiples of 8 (16-byte rows), but for chunk_score
