#!/usr/bin/env python3
"""Time the chunk_score, chunk_attention and decode_attention kernels at the
main path's shapes (full-width Qwen2.5-7B: 28/4 heads, d 128; identify over
a 4096-token prefix with float32 queries; part B over 64 chunks of 16 tokens
and a 64-token float32 suffix; decode over 68 bfloat16 pages of 16 tokens
and one pad slot), selective_scan's decode step at hymba-1.5b's and
falcon-mamba-7b's widths (d_inner 3200 and 8192, n 16, bfloat16 x, seeded),
and flash_attention at the dense ingest (1 x 28/4 heads, s 4096, d 128,
bfloat16, causal) and at full-width qwen3-1.7b's training shape (1 x 16/8
heads): the forward with and without the logsumexp its backward reads, and
the backward causal and with window 1024, each on the model's (b, s, n, d)
tensors read through transposed views; on one CUDA card, without the rest
of chip_smoke.py. Run from the root of a checkout:

    python3 scripts/bench_attention_kernels.py

For each kernel it prints the device time of one call and the wrapper's host
time per call, measured by chip_smoke.py's own helpers, and each device
kernel's own time per call under torch.profiler; first, the same device
time of a one-element PyTorch kernel, the floor of that measure. The last
line is one JSON object with every number.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_ms(fn, calls: int = 20) -> dict:
    """{device kernel: its own device time per call, ms} over ``calls`` calls
    of fn under torch.profiler (the kernels' durations, without the gaps
    between launches that the CUDA-event time of a call includes); the
    session idles 20 ms after it starts and before it stops, as a bare one
    can drop kernels near its edges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_events, kernel_name

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    return {kernel_name(k): round(t / 1e3 / calls, 5) for k, _, t in device_events(prof)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_attention_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import device_ms, host_ms
    from repro_torch.kernels import build as B
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    B.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s, nq, nkv, d, c, nb = 64, 28, 4, 128, 16, 64
    q, kf, vf = rn(s, nq, d), rn(s, nkv, d), rn(s, nkv, d)
    ks, vs = (rn(nb, c, nkv, d, dtype=torch.float16) for _ in range(2))
    n_pages = 69
    qd = rn(1, nq, d, dtype=torch.bfloat16)
    kp, vp = (rn(1, n_pages, c, nkv, d, dtype=torch.bfloat16) for _ in range(2))
    tbl = torch.cat([torch.arange(n_pages - 1, dtype=torch.int32, device=dev)[None],
                     torch.full((1, 1), -1, dtype=torch.int32, device=dev)], 1)
    lens = torch.tensor([(n_pages - 2) * c + 5], dtype=torch.int32, device=dev)
    kc = rn(4096, nkv, d, dtype=torch.float16)

    def scan_step(d_in, n=16):  # the decode step as mamba_decode_step calls it
        proj = rn(1, 1, 2 * n + 1, dtype=torch.bfloat16)
        args = (rn(1, 1, d_in, dtype=torch.bfloat16),
                torch.nn.functional.softplus(rn(1, 1) - 2.0), -torch.exp(rn(d_in, n)),
                proj[..., :n], proj[..., n: 2 * n], rn(1, d_in, n))
        return lambda: ss.selective_scan(*args)

    def bshd(s_, n):  # a (b, s, n, d) projection read as (b, n, s, d)
        return rn(1, s_, n, d, dtype=torch.bfloat16).transpose(1, 2)
    qi, ki, vi = bshd(4096, nq), bshd(4096, nkv), bshd(4096, nkv)
    qt, kt, vt, dot = bshd(4096, 16), bshd(4096, 8), bshd(4096, 8), bshd(4096, 16)
    lse = {w: fa.lse_buffer(qt) for w in (0, 1024)}
    out = {w: fa.flash_attention(qt, kt, vt, window=w, lse=lse[w]) for w in (0, 1024)}

    def backward(w):  # as FlashAttentionFn calls it, on the lse its forward wrote
        return lambda: fa.flash_attention_bwd(qt, kt, vt, out[w], dot, window=w, lse=lse[w])
    calls = {"chunk_score": lambda: cs.chunk_score(q, kc, c),
             "chunk_attention": lambda: ca.chunk_attention(q, ks, vs, nb, kf, vf),
             "decode_attention": lambda: da.decode_attention(qd, kp, vp, tbl, lens),
             "selective_scan decode step, hymba": scan_step(3200),
             "selective_scan decode step, falcon-mamba": scan_step(8192),
             "flash_attention, dense ingest": lambda: fa.flash_attention(qi, ki, vi),
             "flash_attention, training shape": lambda: fa.flash_attention(qt, kt, vt),
             "flash_attention with lse, training shape":
                 lambda: fa.flash_attention(qt, kt, vt, lse=lse[0]),
             "flash_attention_bwd, training shape": backward(0),
             "flash_attention_bwd, training shape, window 1024": backward(1024)}
    res = {"card": smi}
    one = torch.zeros(1, device=dev)
    res["floor_ms"] = device_ms(lambda: one.add_(1.0))
    print(f"floor: one PyTorch kernel on one element {res['floor_ms']:.4f} ms between events")
    for name, fn in calls.items():
        r = dict(ms=device_ms(fn), host_ms=host_ms(fn, reps=200), kernels_ms=kernel_ms(fn))
        res[name] = r
        print(f"{name}: {r['ms']:.4f} ms on the card, host {r['host_ms']:.4f} ms per call; "
              f"device kernels (profiler, ms per call) {r['kernels_ms']}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
