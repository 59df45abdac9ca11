#!/usr/bin/env python3
"""How often a short torch.profiler session on the card sees no device
events, with and without idle time around the profiled calls.

The gpu tests count each kernel wrapper's device kernels per call by
profiling 10 calls (``_device_kernels`` in tests/test_torch_gpu.py); such a
session lasts about a millisecond. This script runs that session many times
over the chunk_score call of the test (the call that came back empty) and a
decode_attention call, once as the session was (``bare``) and once with
``PAD_S`` of idle host time after the profiler starts and before it stops
(``padded``, the helper's form now), and for every session records the
device events it kept, and where the first and last of them lie on the
profiler's clock against the session's own start and length. Run from the
root of a checkout on one card:

    python3 scripts/check_profiler_window.py [sessions]

The last line is one JSON object with the counts per form.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAD_S = 0.02
CALLS = 10


def session(fn, pad_s: float) -> dict:
    """One profiled session of CALLS calls of fn: the device events kept,
    the first and last one's start (us) from the trace's start, and the
    host time the session spanned (us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if pad_s:
            time.sleep(pad_s)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
        span_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    starts = sorted(e.time_range.start for e in dev)
    return {"n": len(dev), "first_us": starts[0] if starts else None,
            "last_us": starts[-1] if starts else None, "span_us": span_us}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_profiler_window: no CUDA device", file=sys.stderr)
        return 2
    n_sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import build as B
    from repro_torch.kernels.chunk_score import ops as cs_ops
    from repro_torch.kernels.decode_attention import ops as da_ops

    B.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(64, 28, 128, device=dev, generator=g)
    kc = torch.randn(4096, 4, 128, device=dev, generator=g).to(torch.float16)
    # the test's decode case: one request over 69 of 70 pages of 16 tokens
    kp = torch.randn(1, 70, 16, 4, 128, device=dev, generator=g).to(torch.bfloat16)
    vp = torch.randn(1, 70, 16, 4, 128, device=dev, generator=g).to(torch.bfloat16)
    qd = torch.randn(1, 28, 128, device=dev, generator=g).to(torch.bfloat16)
    tbl = torch.randperm(70, device=dev, generator=g)[:69].to(torch.int32)[None]
    lens = torch.tensor([68 * 16 + 5], device=dev, dtype=torch.int32)
    calls = {"chunk_score": lambda: cs_ops.chunk_score(q, kc, 16),
             "decode_attention": lambda: da_ops.decode_attention(qd, kp, vp, tbl, lens)}
    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi)
    out = {"device": smi, "sessions": n_sessions, "pad_s": PAD_S, "calls": CALLS}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        for form, pad in (("bare", 0.0), ("padded", PAD_S)):
            t0 = time.perf_counter()
            got = [session(fn, pad) for _ in range(n_sessions)]
            counts = sorted({s["n"] for s in got})
            empty = [i for i, s in enumerate(got) if s["n"] == 0]
            kept = [s for s in got if s["n"]]
            firsts = sorted(s["first_us"] for s in kept)
            lasts = sorted(s["last_us"] - s["span_us"] for s in kept)
            row = {"empty": len(empty), "empty_at": empty[:20], "events": counts,
                   "first_event_us": [firsts[0], firsts[len(firsts) // 2], firsts[-1]]
                   if firsts else None,
                   "last_event_minus_span_us": [lasts[0], lasts[len(lasts) // 2], lasts[-1]]
                   if lasts else None,
                   "seconds": round(time.perf_counter() - t0, 2)}
            out[f"{name}/{form}"] = row
            print(f"{name} {form}: {row}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
