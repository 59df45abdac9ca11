#!/usr/bin/env python3
"""Time the chunk_attention and decode_attention kernels at the main path's
shapes (full-width Qwen2.5-7B: 28/4 heads, d 128; part B over 64 chunks of
16 tokens and a 64-token float32 suffix; decode over 68 bfloat16 pages of 16
tokens and one pad slot), on one CUDA card, without the rest of
chip_smoke.py. Run from the root of a checkout:

    python3 scripts/bench_attention_kernels.py

For each kernel it prints the device time of one call and the wrapper's host
time per call, measured by chip_smoke.py's own helpers. The last line is one
JSON object with every number.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_attention_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import device_ms, host_ms
    from repro_torch.kernels import build as B
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.decode_attention import ops as da

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
    calls = {"chunk_attention": lambda: ca.chunk_attention(q, ks, vs, nb, kf, vf),
             "decode_attention": lambda: da.decode_attention(qd, kp, vp, tbl, lens)}
    res = {"card": smi}
    for name, fn in calls.items():
        r = dict(ms=device_ms(fn), host_ms=host_ms(fn, reps=200))
        res[name] = r
        print(f"{name}: {r['ms']:.4f} ms on the card, host {r['host_ms']:.4f} ms per call")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
