#!/usr/bin/env python3
"""selective_scan's backward alone, built from this checkout's
csrc/selective_scan.cu by itself (~25 s, not the whole library), for
iterating on the kernel:

    python3 scripts/scan_bwd_check.py

1. ptxas -v of every backward kernel instance (registers, spill bytes) and
   its CTAs an SM from the occupancy calculator (``ops.bwd_ctas_per_sm``);
2. the backward against its plain versions (``selective_scan_bwd_ref`` and
   ``selective_scan_bwd_chunked_ref`` at runs of ``ops.BWD_RUN``) at edge
   shapes in float32, bfloat16 and float16, with and without h0 and
   dh_final, two runs bit for bit; the tolerances of tests/test_torch_gpu.py
   (``SCAN_BWD_REL``); only failures are printed, then their count;
3. float32 accuracy at hymba-1.5b's training shape (b 1, s 4096, d_in 3200,
   n 16; float32 x, dt, B and C, so every output is float32): each
   gradient's relative L2 error against a float64 evaluation of the plain
   version, for the kernel and for the plain version in float32;
4. the median device time of one call (``chip_smoke.device_ms``) at
   hymba-1.5b's and falcon-mamba-7b's training shapes (bfloat16) and at a
   width of 264 CTAs (two on every SM of an H100).

Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")
EDGE_SHAPES = [(1, 1, 40, 16), (2, 5, 24, 8), (1, 15, 100, 4), (2, 16, 48, 16),
               (1, 255, 40, 32), (2, 257, 100, 16), (1, 700, 64, 2), (2, 773, 200, 16),
               (2, 40, 33, 16), (1, 512, 8, 16), (2, 300, 24, 32), (2, 259, 17, 2)]


def build_alone(B, out: Path):
    """selective_scan.cu and a stub of ckv_error_string compiled into one
    library; returns (ctypes library, the compilers' log)."""
    (out / "stub.cu").write_text('#include <cuda_runtime.h>\nextern "C" const char* '
                                 'ckv_error_string(int c) { return cudaGetErrorString('
                                 '(cudaError_t)c); }\n')
    nvcc = B._nvcc()
    procs = [subprocess.Popen([nvcc, *B.NVCC_FLAGS, "-c", str(src), "-o", str(out / f"{i}.o")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, src in enumerate([B.CSRC / "selective_scan.cu", out / "stub.cu"])]
    log = ""
    for p in procs:
        log += p.communicate()[0]
        if p.returncode:
            raise RuntimeError(log)
    so = out / "libscan.so"
    subprocess.run([nvcc, *B.NVCC_FLAGS, "-shared", str(out / "0.o"), str(out / "1.o"), "-o",
                    str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in B.SIGNATURES.items():
        if "selective_scan" in name:
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.ckv_error_string.argtypes = [ctypes.c_int]
    lib.ckv_error_string.restype = ctypes.c_char_p
    for name, n_args in (("ckv_selective_scan_scratch", 4), ("ckv_selective_scan_bwd_scratch", 4),
                         ("ckv_selective_scan_bwd_work_floats", 4),
                         ("ckv_selective_scan_bwd_occupancy", 2)):
        getattr(lib, name).argtypes = [ctypes.c_int] * n_args
        getattr(lib, name).restype = ctypes.c_longlong
    return lib, log


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build as B
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_chunked_ref,
                                                       selective_scan_bwd_ref)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        lib, log = build_alone(B, Path(tmp))
        B.library = lambda: lib  # the wrappers call build.library() at each launch
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "selective_scan_bwd_kernel" in line:
                inst = re.search(r"bwd_kernelI(\w+?)Li(\d+)E", line)
                info = " ".join(m[0] for x in lines[i + 1: i + 5] for m in [re.search(
                    r"\d+ bytes spill stores, \d+ bytes spill loads|Used \d+ registers", x)] if m)
                print(f"ptxas: selective_scan_bwd_kernel<{inst[1]}, {inst[2]}>: {info}")
        for dt_ in (torch.bfloat16, torch.float16, torch.float32):
            print(f"CTAs an SM, {dt_}: ",
                  {n: ss.bwd_ctas_per_sm(n, dt_) for n in (2, 4, 8, 16, 32)})

        def rnd(seed, shape, dtype=torch.float32):
            g = torch.Generator(device="cuda").manual_seed(seed)
            return torch.randn(shape, generator=g, device="cuda").to(dtype)

        def args(b, s, d_in, n, dtype, seed):
            x = rnd(seed, (b, s, d_in), dtype)
            dt = torch.nn.functional.softplus(rnd(seed + 1, (b, s)) - 1.0).to(dtype)
            A = -torch.exp(rnd(seed + 2, (d_in, n)))
            proj = rnd(seed + 3, (b, s, 2 * n + 1), dtype)
            return x, dt, A, proj[..., :n], proj[..., n: 2 * n]

        rel = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
        bad = 0
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for b, s, d_in, n in EDGE_SHAPES:
                for seeded in (False, True):
                    x, dt, A, Bm, Cm = args(b, s, d_in, n, dtype, 400)
                    h0 = rnd(405, (b, d_in, n)) if seeded else None
                    dh = rnd(406, (b, d_in, n)) if seeded else None
                    dy = rnd(407, (b, s, d_in))
                    car = ss.carries_buffer(x, n) if ss.variant_for(s) == "chunked" else None
                    with torch.no_grad():
                        ss.selective_scan(x, dt, A, Bm, Cm, h0, carries=car)
                        got = ss.selective_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh, carries=car)
                        again = ss.selective_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh, carries=car)
                        wants = [selective_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh),
                                 selective_scan_bwd_chunked_ref(x, dt, A, Bm, Cm, h0, dy, dh,
                                                                chunk=ss.CHUNK, run=ss.BWD_RUN)]
                    ok = all(torch.equal(u, v) for u, v in zip(got, again))
                    for want in wants:
                        for k, g, w in zip(GRADS, got, want):
                            r = rel[dtype] if k in ("dx", "ddt", "dB", "dC") else 1e-5
                            err = (g.float() - w.float()).abs().max().item()
                            ok &= g.dtype == w.dtype and err <= r * w.float().abs().max().item()
                    if not ok:
                        bad += 1
                        print(f"FAILED: {dtype} (b, s, d_in, n) {(b, s, d_in, n)} h0 and dh_final "
                              f"{seeded}")
        print(f"edge shapes: {bad} of {3 * len(EDGE_SHAPES) * 2} cases failed")

        x, dt, A, Bm, Cm = args(1, 4096, 3200, 16, torch.float32, 11)
        dy = rnd(12, (1, 4096, 3200))
        car = ss.carries_buffer(x, 16)
        with torch.no_grad():
            ss.selective_scan(x, dt, A, Bm, Cm, carries=car)
            k32 = ss.selective_scan_bwd(x, dt, A, Bm, Cm, None, dy, carries=car)
            f64 = torch.float64
            w64 = selective_scan_bwd_ref(*(t.to(f64) for t in (x, dt, A, Bm, Cm)), None,
                                         dy.to(f64))
            p32 = selective_scan_bwd_ref(x, dt, A, Bm, Cm, None, dy)

        def l2(v, t):
            return ((v.double() - t).norm() / t.norm()).item()

        print("float32 relative L2 error against float64, hymba's shape: " + "; ".join(
            f"{k} kernel {l2(a_, t):.3e} plain {l2(b_, t):.3e}"
            for k, a_, b_, t in zip(GRADS, k32, p32, w64)) + f" ({smi})")
        del x, dy, car, k32, w64, p32
        torch.cuda.empty_cache()

        for label, d_in in (("hymba-1.5b", 3200), ("falcon-mamba-7b", 8192),
                            ("264 CTAs", 264 * 16)):
            x, dt, A, Bm, Cm = args(1, 4096, d_in, 16, torch.bfloat16, 11)
            car = ss.carries_buffer(x, 16)
            dy = rnd(12, (1, 4096, d_in))
            with torch.no_grad():
                ss.selective_scan(x, dt, A, Bm, Cm, carries=car)
                ms = [cs.device_ms(lambda: ss.selective_scan_bwd(x, dt, A, Bm, Cm, None, dy,
                                                                 carries=car), reps=10)
                      for _ in range(3)]
            print(f"backward at {label}'s width (s 4096, d_in {d_in}, n 16, bfloat16): "
                  + ", ".join(f"{t:.4f}" for t in ms) + f" ms ({smi})")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
