#!/usr/bin/env python3
"""Time chunk_score with its products as split-TF32 mma.sync m16n8k8 terms
against the kernel as it stands (split float16 m16n8k16 terms), on one CUDA
card.

The TF32 variant is a copy of ``src/`` under ``build/variants/tf32/`` with
``csrc/chunk_score.cu`` edited: q split hi + lo without row scaling, every
warp converting its key fragments to TF32; the edits fail loudly when the
kernel's text no longer has what they replace. Each form is built and run
in its own process at the main path's shape (full-width Qwen2.5-7B: 64
suffix rows, 28/4 heads, d 128, 4096 prefix keys, c 16). Run from the root
of a checkout:

    python3 scripts/chunk_score_variants.py

For each form and q dtype it prints the device time of a call
(``chip_smoke.device_ms``), each device kernel's own time under the
profiler, and the largest error against ``chunk_score_ref`` relative to the
largest score. The last line is one JSON object with every number.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"


def _at(text: str, anchor: str) -> int:
    if text.count(anchor) != 1:
        raise RuntimeError(f"chunk_score.cu no longer has: {anchor[:60]!r}")
    return text.index(anchor)


def _tf32(t: str) -> str:
    """The split pass's products as split-TF32 m16n8k8 terms."""
    s = _at(t, "  // this lane's rows (g and g + 8 of its warp), each scaled")
    e = _at(t, "  const int n_grp = FAST ? 4 : (d + 31) / 32;")
    t = t[:s] + '''  int lrow[2];
  float row_scale[2] = {scale2, scale2};
  uint32_t qh[4][4][4], ql[4][4][4];
  {
    float v[2][4][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] = warp * 16 + g + 8 * i;
      const int r = r0 + lrow[i];
      const TQ* src = q + ((size_t)(r / G) * n_q + h * G + r % G) * d + 8 * t;
#pragma unroll
      for (int gr = 0; gr < 4; ++gr) {
        if (r < rows && 32 * gr + 8 * t < d) {
          load8<TQ>(src + 32 * gr, v[i][gr]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[i][gr][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int gr = 0; gr < 4; ++gr)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a[4] = {v[0][gr][2 * u], v[1][gr][2 * u], v[0][gr][2 * u + 1],
                            v[1][gr][2 * u + 1]};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (Q_SPLIT) tf32_split(a[x], qh[gr][u][x], ql[gr][u][x]);
          else qh[gr][u][x] = __float_as_uint(a[x]), ql[gr][u][x] = 0u;
        }
      }
  }
''' + t[e:]
    s = _at(t, "      // the 8 n-tiles' products are independent")
    e = _at(t, "    // online softmax in log2 units")
    return t[:s] + '''#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t b0[8], b1[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __half* kh = reinterpret_cast<const __half*>(&kw[nt]);
          b0[nt] = __float_as_uint(__half2float(kh[2 * u]));
          b1[nt] = __float_as_uint(__half2float(kh[2 * u + 1]));
        }
        if (Q_SPLIT)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma_tf32(sc[nt], ql[gr][u], b0[nt], b1[nt]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_tf32(sc[nt], qh[gr][u], b0[nt], b1[nt]);
      }
    }
''' + t[e:]


def make_tf32_variant() -> Path:
    dst = OUT / "tf32"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src" / "repro_torch" / "csrc" / "chunk_score.cu"
    cu.write_text(_tf32(cu.read_text()))
    return dst


def run_form(src: Path) -> dict:
    """In this process: build the kernels of ``src``, time chunk_score."""
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "scripts"), str(src)]
    from bench_attention_kernels import kernel_ms
    from chip_smoke import device_ms
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.chunk_score.ref import chunk_score_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    k = torch.randn(4096, 4, 128, generator=gen, device=dev).half()
    out = {}
    for qdt in (torch.float32, torch.bfloat16):
        q = torch.randn(64, 28, 128, generator=gen, device=dev).to(qdt)
        got, ref = cs.chunk_score(q, k, 16), chunk_score_ref(q, k, 16)
        out[str(qdt).removeprefix("torch.")] = dict(
            rel_err=((got - ref).abs().max() / ref.abs().max()).item(),
            ms=device_ms(lambda: cs.chunk_score(q, k, 16)),
            kernels_ms=kernel_ms(lambda: cs.chunk_score(q, k, 16)))
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        print(json.dumps(run_form(Path(sys.argv[2]))))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chunk_score_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    res = {"card": smi}
    for name, src in (("float16", ROOT / "src"), ("tf32", make_tf32_variant() / "src")):
        proc = subprocess.run([sys.executable, __file__, "--run", str(src)], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        res[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        for qdt, r in res[name].items():
            print(f"{name} products, q {qdt}: {r['ms']:.4f} ms a call, kernels "
                  f"{r['kernels_ms']}, rel err {r['rel_err']:.3g}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
