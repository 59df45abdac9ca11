#!/usr/bin/env python3
"""Drive the PyTorch port of ContiguousKV on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code:

  1. device   — the card's name and power limit (nvidia-smi), then the build
                of the CUDA kernels from csrc/ with nvcc, timed;
  2. kernels  — chunk_score, chunk_attention and decode_attention at the
                main path's shapes on full-width Qwen2.5-7B, each held
                against its plain PyTorch version on the same card inputs
                (tolerances stated below), timed beside its plain version,
                the least time the card could take (bound) and, where one
                exists, one PyTorch call computing the same function
                (library); for chunk_attention and decode_attention also the
                wrapper's host time per call and an output-only yardstick:
                one scaled_dot_product_attention call on pre-laid contiguous
                inputs, which computes no mass and which the port never
                calls;
  3. e2e      — ContiguousKV Re-Prefill then decode on full-width
                Qwen2.5-7B (28 layers, random bfloat16 weights from a seeded
                generator on the card): ingest a 4096-token prefix (through
                flash_attention, its launches asserted), serve 4 requests of
                a 64-token suffix with 16 decode tokens each at budget 0.25,
                period 8, subperiod 4, c=16; assert read amplification 1.0
                and each kernel's launch count per request; print where each
                request's time goes and profile one more request (device
                busy time, idle share, top device ops, and the device
                kernels each wrapper call ran: exactly one decode kernel,
                part B's attention pass and merge, the mass pass for
                chunk_score alone); hold a budget-1.0
                run's first-token logits against the dense forward over
                prefix + suffix;
  4. state    — flash_attention (hymba prefill, dense ingest, ragged s,
                window, q_offset) and selective_scan (hymba and falcon-mamba
                prefill, a ragged s, resumes from the carried state at a
                chunk boundary and a ragged cut, decode at b = 1 and 2)
                checked and timed as in phase 2; then the state-space path
                (StateSpaceEngine over StateCompute) on full-width
                hymba-1.5b (32 layers, random bfloat16 weights from a
                seeded generator): 4 requests of the same 4096-token
                prefix + 64-token suffix with 16 decode tokens each, with
                flash_attention and selective_scan launches asserted per
                request and per kernel variant, timed and profiled as
                above; decode's logits held against a prefill over the
                same tokens; then one request on
                full-width falcon-mamba-7b (64 layers, attention-free);
  5. a ``{"kernels": [...]}`` JSON line with each kernel's launches on the
     paths it names (per variant where a wrapper has several), its error
     against its plain version, its times and its bound (the largest of
     bytes, products and exponentials, named);
  6. last line: ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero, printing no result, without one or
outside a checkout (it builds and imports ``src/repro_torch``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM data-sheet peaks (dense). ``bound_ms`` takes the products at the
# bfloat16/float16 tensor-core rate. chunk_score and decode_attention's P V
# run float32 products on the CUDA cores instead (the engine's queries and
# suffix KV are float32 from layer 0's part B on, and each kernel is held to
# 1e-5 of its float32 plain version, which bfloat16 operands would miss), so
# the line also gives the bound at the float32 CUDA-core rate; chunk_attention
# runs its products as split-TF32 terms on the tensor cores, so its line
# also gives the bound of those terms at the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
TENSOR_CORE_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
CUDA_CORE_FP32_OPS_PER_S = 67e12
# The special-function units: 16 exponentials (ex2) per clock per SM on
# compute capability 9.0 (CUDA C Programming Guide, arithmetic instruction
# throughput), times the SMs, times the card's maximum SM clock as
# nvidia-smi reads it (phase_device sets EXP_PER_S).
SFU_EXP_PER_CLOCK_PER_SM = 16
EXP_PER_S = None

# full-width main path (serve.py's default prefix length); the state-space
# phase serves the same request shape
PREFIX_LEN, SUFFIX_LEN, DECODE_TOKENS, N_REQUESTS = 4096, 64, 16, 4
BUDGET, PERIOD, SUBPERIOD, CHUNK = 0.25, 8, 4, 16
# budget-1.0 first-token logits against the dense forward: the engine keeps
# a float32 hidden state from layer 0's part B on and reads float16 store
# KV, while the dense forward runs all 28 layers in bfloat16, so the two
# differ by bfloat16 rounding compounded over 28 layers where the reduced
# test (4 layers) allows 3e-2. An H100 run measured 0.016 of the largest
# logit and cosine 0.99986; the limits leave about 3x room
DENSE_REL_TOL, DENSE_MIN_COS = 0.05, 0.999
# flash_attention in bfloat16 multiplies P, rounded to bfloat16, on the
# tensor cores (the plain version keeps P in float32) and rounds the output
# once: 2^-7 of the largest output, about one bfloat16 ulp
FLASH_REL = 2.0 ** -7
# selective_scan against its plain version: the same float32 recurrence,
# the kernel contracting multiply-adds and summing y in another order
SCAN_REL = 1e-5
# decode's logits against a prefill over the same tokens, hymba. The check
# is of the state decode carries (h, conv window, KV cache), so it runs on
# float32 copies of the same weights, where both sides compute in float32
# and a wrong state would show far above rounding: the dense check's limits.
STEP_REL_TOL, STEP_MIN_COS = DENSE_REL_TOL, DENSE_MIN_COS
# The same check as served, in bfloat16: both sides round every op to
# bfloat16 through 32 layers in different orders (GEMV against GEMM, the
# decode's bfloat16 scores against flash_attention's float32 ones, decode's
# float32 dt against prefill's bfloat16 dt), some 600 roundings of 2^-9 in a
# random walk: ~0.05 of the largest logit. An H100 run measured 0.0517 and
# cosine 0.99904 at step 1; the limits leave about 2x room
STEP_BF16_REL_TOL, STEP_BF16_MIN_COS = 0.1, 0.998


def fail(msg: str):
    raise RuntimeError(msg)


def device_ms(fn, reps: int = 30) -> float:
    """Median device time of one call of ``fn``: every call is bracketed by
    CUDA events and all calls sit queued behind a sleep kernel, so the host's
    enqueue time never shows as device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the host enqueues every call meanwhile
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def wall_ms(fn, reps: int = 10) -> float:
    """Median host time of one call of ``fn`` up to a synchronize (the plain
    versions are many small launches, some with host round trips)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bounds(nbytes: float, ops: float, exps: float, tf32_ops: float | None = None):
    """{"tensor_core" | "cuda_core" [| "tf32"]: (least ms, "bytes" |
    "operations", term)} on the H100: the largest of the bytes over the
    memory rate, the products at either rate, and the exponentials over the
    special-function units' rate; ``term`` names it ("bytes", "products" or
    "exponentials", the last two being operations). ``tf32_ops`` counts the
    products of split-TF32 terms a kernel runs, at the TF32 rate."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "exponentials": exps / EXP_PER_S * 1e3}
    out = {}
    rates = [("tensor_core", ops, TENSOR_CORE_OPS_PER_S),
             ("cuda_core", ops, CUDA_CORE_FP32_OPS_PER_S)]
    if tf32_ops is not None:
        rates.append(("tf32", tf32_ops, TF32_OPS_PER_S))
    for name, n_ops, rate in rates:
        t = dict(terms, products=n_ops / rate * 1e3)
        term = max(t, key=t.get)
        out[name] = (t[term], "bytes" if term == "bytes" else "operations", term)
    return out


def bound_text(bound) -> str:
    tc, cc = bound["tensor_core"], bound["cuda_core"]
    text = (f"bound {tc[0]:.5f} ms by {tc[2]} at the tensor-core rate, {cc[0]:.5f} ms by "
            f"{cc[2]} at the float32 CUDA-core rate")
    if "tf32" in bound:
        text += f", {bound['tf32'][0]:.5f} ms by {bound['tf32'][2]} for its split-TF32 terms"
    return text


def reset_counts(*mods):
    """Set each wrapper's launch counts, total and per variant, to 0."""
    for mod in mods:
        mod.launches = 0
        if hasattr(mod, "launches_by_variant"):
            mod.launches_by_variant = dict.fromkeys(mod.launches_by_variant, 0)


def counts(mod) -> dict:
    """A wrapper's launches: the total, and per variant where it has several."""
    out = {"launches": mod.launches}
    if hasattr(mod, "launches_by_variant"):
        out.update({k: v for k, v in mod.launches_by_variant.items() if v})
    return out


def host_ms(fn, reps: int = 50) -> float:
    """Mean host time of one call of ``fn`` without a synchronize: the
    wrapper's own cost (argument checks, tensor maps, the launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dname(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_device():
    global EXP_PER_S
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    import torch

    max_sm_mhz = float(clk.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_PER_S = SFU_EXP_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
    print(f"device: {sms} SMs at a maximum SM clock of {max_sm_mhz:.0f} MHz: "
          f"{EXP_PER_S / 1e12:.3f} T exponentials/s on the special-function units")
    from repro_torch.kernels import build as B

    t0 = time.perf_counter()
    lib = B.build()
    B.library()
    print(f"device: build of {lib.name} took {time.perf_counter() - t0:.2f} s")


def phase_kernels(cfg):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.chunk_attention.ops import chunk_attention
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.chunk_score.ops import chunk_score
    from repro_torch.kernels.chunk_score.ref import chunk_score_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s, nq, nkv, d = SUFFIX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    m = -(-PREFIX_LEN // CHUNK)
    n_sel = math.ceil(BUDGET * m)
    rows = {}

    # chunk_score: float32 q as at every identify past layer 0; also the
    # bfloat16 q of layer 0 and a ragged prefix (4100 tokens)
    for qdt, n in ((torch.float32, PREFIX_LEN), (torch.bfloat16, PREFIX_LEN),
                   (torch.float32, PREFIX_LEN + 4)):
        q, kk = rn(s, nq, d, dtype=qdt), rn(n, nkv, d, dtype=torch.float16)
        got, ref = chunk_score(q, kk, CHUNK), chunk_score_ref(q, kk, CHUNK)
        err, tol = max_err(got, ref), 1e-5 * ref.abs().max().item() + 1e-6
        if not err <= tol:
            fail(f"chunk_score {dname(q)} n={n}: max abs err {err} > {tol}")
        if not torch.equal(got, chunk_score(q, kk, CHUNK)):
            fail("chunk_score is not reproducible bit for bit")
        print(f"kernels: chunk_score q {dname(q)} n={n}: max abs err {err:.3g} "
              f"(tol {tol:.3g}), two runs bit-identical")
        if qdt == torch.float32 and n == PREFIX_LEN:
            rows["chunk_score"] = dict(
                err=err, ms=device_ms(lambda: chunk_score(q, kk, CHUNK)),
                plain_ms=wall_ms(lambda: chunk_score_ref(q, kk, CHUNK)),
                bound=bounds(nbytes(q, kk) + 4 * m, 2.0 * s * nq * n * d, s * nq * n))

    # chunk_attention: float32 q/suffix KV (layers past 0) and bfloat16 (layer 0)
    ks, vs = (rn(n_sel, CHUNK, nkv, d, dtype=torch.float16) for _ in range(2))
    for qdt, n_valid in ((torch.float32, n_sel), (torch.bfloat16, n_sel),
                         (torch.float32, n_sel - 7)):
        q, kf, vf = rn(s, nq, d, dtype=qdt), rn(s, nkv, d, dtype=qdt), rn(s, nkv, d, dtype=qdt)
        (o, ms), (o2, ms2) = (chunk_attention(q, ks, vs, n_valid, kf, vf),
                              chunk_attention_ref(q, ks, vs, n_valid, kf, vf))
        err = max(max_err(o, o2), max_err(ms, ms2))
        tol = 1e-5 * max(o2.abs().max().item(), ms2.abs().max().item()) + 1e-6
        if not err <= tol or o.dtype != torch.float32:
            fail(f"chunk_attention {dname(q)} n_valid={n_valid}: err {err} > {tol}")
        print(f"kernels: chunk_attention q {dname(q)} chunks {n_valid}/{n_sel}: "
              f"max abs err {err:.3g} (tol {tol:.3g}) on out and A_j")
        if not (torch.equal(o, chunk_attention(q, ks, vs, n_valid, kf, vf)[0])
                and torch.equal(ms, chunk_attention(q, ks, vs, n_valid, kf, vf)[1])):
            fail("chunk_attention is not reproducible bit for bit")
        if qdt == torch.float32 and n_valid == n_sel:
            pairs_c, pairs_s = s * n_valid * CHUNK, s * (s + 1) // 2
            pairs = pairs_c + pairs_s

            def call(q=q, kf=kf, vf=vf, n_valid=n_valid):  # this iteration's inputs
                return chunk_attention(q, ks, vs, n_valid, kf, vf)
            # output-only yardstick: float32 SDPA over pre-laid [chunks ; suffix]
            # with a boolean mask (chunks visible, the suffix causal)
            n_pre = n_valid * CHUNK
            k_all, v_all = (torch.cat([x[:n_valid].reshape(n_pre, nkv, d).float(), y])
                            .permute(1, 0, 2)[None].contiguous() for x, y in ((ks, kf), (vs, vf)))
            q_t = q.permute(1, 0, 2)[None].contiguous()
            mask = torch.ones(s, n_pre + s, dtype=torch.bool, device=dev)
            mask[:, n_pre:] = torch.ones(s, s, dtype=torch.bool, device=dev).tril()

            def sdpa():
                return F.scaled_dot_product_attention(q_t, k_all, v_all, attn_mask=mask,
                                                      enable_gqa=True)
            sdpa_err = max_err(sdpa()[0].permute(1, 0, 2), o)
            rows["chunk_attention"] = dict(
                err=err, ms=device_ms(call), host_ms=host_ms(call),
                plain_ms=wall_ms(lambda: chunk_attention_ref(q, ks, vs, n_valid, kf, vf)),
                sdpa_output_only_ms=device_ms(sdpa),
                bound=bounds(nbytes(q, kf, vf, o, ms) + nbytes(ks, vs) * n_valid // n_sel,
                             4.0 * nq * d * pairs, nq * pairs,
                             tf32_ops=4.0 * nq * d * (2 * pairs_c + 3 * pairs_s)))
            print(f"kernels: chunk_attention output-only yardstick "
                  f"scaled_dot_product_attention (float32, boolean mask; computes no A_j, the "
                  f"port never calls it) agrees to {sdpa_err:.3g}")

    # decode_attention: bfloat16 as decode runs; the last step's pool of
    # 64 resident pages + 5 tail pages, a partial last page, one pad slot
    n_res, n_tail = n_sel, -(-(s + DECODE_TOKENS) // CHUNK)
    n_pages = n_res + n_tail
    q = rn(1, nq, d, dtype=torch.bfloat16)
    kp, vp = (rn(1, n_pages, CHUNK, nkv, d, dtype=torch.bfloat16) for _ in range(2))
    tight = torch.arange(n_pages - 1, dtype=torch.int32, device=dev)[None]
    wide = torch.cat([tight, torch.full((1, 1), -1, dtype=torch.int32, device=dev)], 1)
    lens = torch.tensor([(n_pages - 2) * CHUNK + 5], dtype=torch.int32, device=dev)
    (o, pm), (o2, pm2) = decode_attention(q, kp, vp, wide, lens), decode_attention_ref(
        q, kp, vp, wide, lens)
    o_t, pm_t = decode_attention(q, kp, vp, tight, lens)
    if not (torch.equal(o, o_t) and torch.equal(pm[..., :-1], pm_t)
            and pm[..., -1].abs().max().item() == 0.0):
        fail("decode_attention: a pad slot changed the real pages' results")
    # bfloat16 output: both round one float32 result, so one bfloat16 ulp
    err_o, tol_o = max_err(o, o2), 2.0 ** -7 * o2.float().abs().max().item()
    err_m, tol_m = max_err(pm, pm2), 1e-5 * pm2.abs().max().item() + 1e-7
    if not (err_o <= tol_o and err_m <= tol_m):
        fail(f"decode_attention: err out {err_o} > {tol_o} or mass {err_m} > {tol_m}")
    print(f"kernels: decode_attention bfloat16 {n_pages - 1} pages + 1 pad slot: max abs "
          f"err out {err_o:.3g} (tol {tol_o:.3g}), mass {err_m:.3g} (tol {tol_m:.3g}); "
          f"pad slot bit-identical")
    o2, pm2 = decode_attention(q, kp, vp, wide, lens)
    if not (torch.equal(o, o2) and torch.equal(pm, pm2)):
        fail("decode_attention is not reproducible bit for bit")
    L = int(lens.item())

    def call(q=q):
        return decode_attention(q, kp, vp, wide, lens)
    # output-only yardstick: bfloat16 SDPA over the valid tokens laid out contiguously
    k_c, v_c = (x[0, : n_pages - 1].reshape(-1, nkv, d)[:L].permute(1, 0, 2)[None].contiguous()
                for x in (kp, vp))
    q_c = q[:, :, None]

    def sdpa():
        return F.scaled_dot_product_attention(q_c, k_c, v_c, enable_gqa=True)
    sdpa_err = max_err(sdpa()[:, :, 0], o)
    rows["decode_attention"] = dict(
        err=max(err_o, err_m), ms=device_ms(call), host_ms=host_ms(call),
        plain_ms=wall_ms(lambda: decode_attention_ref(q, kp, vp, wide, lens)),
        sdpa_output_only_ms=device_ms(sdpa),
        bound=bounds(nbytes(q, o, pm, wide, lens) + 2 * L * nkv * d * kp.element_size(),
                     4.0 * nq * d * L, nq * L))
    print(f"kernels: decode_attention output-only yardstick scaled_dot_product_attention "
          f"(bfloat16, enable_gqa; computes no per-page mass, the port never calls it) agrees "
          f"to {sdpa_err:.3g}; two runs bit-identical")
    for name, r in rows.items():
        extra = ""
        if "host_ms" in r:
            extra = (f"; host time per call {r['host_ms']:.4f} ms; output-only "
                     f"scaled_dot_product_attention {r['sdpa_output_only_ms']:.4f} ms")
        print(f"kernels: {name}: {r['ms']:.4f} ms on the card (plain version "
              f"{r['plain_ms']:.4f} ms, {bound_text(r['bound'])}, "
              f"library call: none returns the per-chunk/page mass{extra})")
    return rows


def phase_state_kernels(hcfg, dcfg, fcfg):
    """flash_attention and selective_scan against their plain versions at
    the state-space path's shapes (and flash at the dense ingest's), timed;
    the scan also at falcon-mamba's prefill and with one CTA per SM."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = {}
    s_full = PREFIX_LEN + SUFFIX_LEN  # the state-space prefill: 4160 tokens
    # flash_attention, bfloat16 as the model runs it, q/k/v read through the
    # (b, s, n, d) projections' transposed views
    cases = [("hymba prefill", hcfg, s_full, s_full, 0, 0),
             ("dense ingest", dcfg, PREFIX_LEN, PREFIX_LEN, 0, 0),
             ("ragged s", hcfg, 1000, 1000, 0, 0),
             ("window 256", hcfg, 1000, 1000, 256, 0),
             ("q_offset 4096", hcfg, SUFFIX_LEN, s_full, 0, PREFIX_LEN)]
    for label, c, s_q, s_k, window, q_offset in cases:
        q = rn(1, s_q, c.n_heads, c.d_head).transpose(1, 2)
        k = rn(1, s_k, c.n_kv_heads, c.d_head).transpose(1, 2)
        v = rn(1, s_k, c.n_kv_heads, c.d_head).transpose(1, 2)
        kw = dict(causal=True, window=window, q_offset=q_offset)
        variant = fa.variant_for(q.dtype, c.d_head)
        got, ref = flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw)
        err, tol = max_err(got, ref), FLASH_REL * ref.float().abs().max().item()
        if not err <= tol:
            fail(f"flash_attention {label}: max abs err {err} > {tol}")
        print(f"kernels: flash_attention {label} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{dname(q)} ({variant}): max abs err {err:.3g} (tol {tol:.3g})")
        if label in ("hymba prefill", "dense ingest"):
            pairs = s_q * (s_q + 1) // 2  # causal key-query pairs of this run
            r = dict(err=err, ms=device_ms(lambda: flash_attention(q, k, v, **kw)),
                     library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=True)),
                     host_ms=host_ms(lambda: flash_attention(q, k, v, **kw)),
                     plain_ms=wall_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=3),
                     bound=bounds(nbytes(q, k, v, got), 4.0 * c.n_heads * c.d_head * pairs,
                                  c.n_heads * pairs))
            print(f"kernels: flash_attention {label}: {variant} {r['ms']:.4f} ms on the card, "
                  f"scaled_dot_product_attention {r['library_ms']:.4f} ms, plain version "
                  f"{r['plain_ms']:.2f} ms, {bound_text(r['bound'])}; host time per call "
                  f"{r['host_ms']:.4f} ms, its tensor maps included")
            if label == "hymba prefill":  # the kernels line's row
                rows["flash_attention"] = r
            else:
                rows["flash_attention"]["dense_ingest"] = {
                    k2: r[k2] for k2 in ("ms", "library_ms", "plain_ms")}
                rows["flash_attention"]["dense_ingest"]["bound_ms"] = r["bound"]["tensor_core"][0]

    # selective_scan: bfloat16 x/B/C with bfloat16-rounded dt (prefill) or
    # float32 dt seeded with h0 (decode); B and C are slices of the (b, s,
    # 2n + 1) projection, as the block passes them
    n = hcfg.ssm_state

    def scan_inputs(b, s, dt_dtype, d_in=hcfg.d_inner):
        x = rn(b, s, d_in)
        dt = F.softplus(rn(b, s, dtype=torch.float32) - 2.0).to(dt_dtype)
        A = -torch.exp(rn(d_in, n, dtype=torch.float32))
        proj = rn(b, s, 2 * n + 1)
        return x, dt, A, proj[..., :n], proj[..., n: 2 * n]

    def check(label, args, h0=None):
        variant = "chunked" if args[0].shape[1] >= ss.CHUNKED_MIN_S else "sequential"
        (y, h), (yr, hr) = selective_scan(*args, h0), selective_scan_ref(*args, h0)
        err = max(max_err(y, yr), max_err(h, hr))
        tol = SCAN_REL * max(yr.abs().max().item(), hr.abs().max().item()) + 1e-6
        if not err <= tol:
            fail(f"selective_scan {label}: max abs err {err} > {tol}")
        print(f"kernels: selective_scan {label} x {tuple(args[0].shape)} {dname(args[0])} "
              f"({variant}): max abs err {err:.3g} on y and h (tol {tol:.3g})")
        return err, y, h

    def scan_bound(args, y, h):  # bytes read and written once; one exp per
        x = args[0]              # (t, channel, state), ~6 float32 operations each
        b, s, d_in = x.shape
        return bounds(nbytes(*args, y, h), 6.0 * b * s * d_in * n, b * s * d_in * n)

    args = scan_inputs(1, s_full, torch.bfloat16)
    err, y_full, h_full = check("hymba prefill", args)
    err = max(err, check("ragged s", scan_inputs(1, s_full - 27, torch.bfloat16))[0])
    # Resuming mid-sequence from the carried state. The chunked kernel
    # re-associates the recurrence within each chunk of ss.CHUNK positions, so
    # a cut on a chunk boundary gives the same chunks, inputs and carries as
    # the whole scan (bit-identical), and a ragged cut the same result within
    # rounding (SCAN_REL). Both parts run the chunked kernel.
    x, dt, A, Bm, Cm = args
    for cut in ((s_full // ss.CHUNK) * ss.CHUNK, s_full - 61):
        _, _, h_mid = check(f"first {cut}", (x[:, :cut].contiguous(), dt[:, :cut], A,
                                             Bm[:, :cut], Cm[:, :cut]))
        _, y_res, h_res = check(f"resumed from h0 at {cut}", (
            x[:, cut:].contiguous(), dt[:, cut:], A, Bm[:, cut:], Cm[:, cut:]), h_mid)
        if cut % ss.CHUNK == 0:
            if not (torch.equal(y_res, y_full[:, cut:]) and torch.equal(h_res, h_full)):
                fail(f"selective_scan: resumed at chunk boundary {cut}, differs from the whole")
            print(f"kernels: selective_scan resumed at {cut} of {s_full} (a chunk boundary): "
                  f"bit-identical to the whole scan")
        else:
            e2 = max(max_err(y_res, y_full[:, cut:]), max_err(h_res, h_full))
            tol = SCAN_REL * max(y_full.abs().max().item(), h_full.abs().max().item()) + 1e-6
            if not e2 <= tol:
                fail(f"selective_scan: resumed at {cut}, max abs err {e2} > {tol}")
            print(f"kernels: selective_scan resumed at {cut} of {s_full} (ragged): max abs err "
                  f"{e2:.3g} against the whole scan (tol {tol:.3g})")
    for b in (1, 2):
        dec = scan_inputs(b, 1, torch.float32)
        h0 = rn(b, hcfg.d_inner, n, dtype=torch.float32)
        err = max(err, check(f"decode b={b}", dec, h0)[0])
    dec = scan_inputs(1, 1, torch.float32)
    h0 = rn(1, hcfg.d_inner, n, dtype=torch.float32)
    fdec = scan_inputs(1, 1, torch.float32, d_in=fcfg.d_inner)
    fh0 = rn(1, fcfg.d_inner, n, dtype=torch.float32)

    def step_bound(a, h_in):  # the decode step: state (and x, dt, B, C, y) moved once
        y, h = selective_scan(*a, h_in)
        d_in = a[0].shape[2]
        return bounds(nbytes(*a, h_in, y, h), 6.0 * d_in * n, d_in * n)["tensor_core"][0]
    r = dict(err=err, ms=device_ms(lambda: selective_scan(*args)), library_ms=None,
             plain_ms=wall_ms(lambda: selective_scan_ref(*args), reps=2),
             decode_ms=device_ms(lambda: selective_scan(*dec, h0)),
             decode_bound_ms=step_bound(dec, h0),
             falcon_decode_ms=device_ms(lambda: selective_scan(*fdec, fh0)),
             bound=scan_bound(args, y_full, h_full))
    print(f"kernels: selective_scan hymba prefill: chunked {r['ms']:.4f} ms on the card, "
          f"plain version {r['plain_ms']:.1f} ms, {bound_text(r['bound'])}; decode step "
          f"(sequential) {r['decode_ms']:.4f} ms against a bound of "
          f"{r['decode_bound_ms']:.5f} ms (its state read and written once), falcon-mamba's "
          f"decode step {r['falcon_decode_ms']:.4f} ms; library call: none, no PyTorch call "
          f"computes the scan")
    # one CTA of 16 channels on each SM: the chunked kernel's latency alone
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = scan_inputs(1, s_full, torch.bfloat16, d_in=16 * sms)
    r["one_cta_per_sm_ms"] = device_ms(lambda: selective_scan(*one))
    print(f"kernels: selective_scan with one CTA per SM (d_in {16 * sms}, s {s_full}): "
          f"{r['one_cta_per_sm_ms']:.4f} ms")
    # falcon-mamba's prefill: d_inner 8192, the same sequence
    fargs = scan_inputs(1, s_full, torch.bfloat16, d_in=fcfg.d_inner)
    _, fy, fh = check("falcon-mamba prefill", fargs)
    r["falcon_prefill"] = dict(ms=device_ms(lambda: selective_scan(*fargs)),
                               bound_ms=scan_bound(fargs, fy, fh)["tensor_core"][0])
    print(f"kernels: selective_scan falcon-mamba prefill (d_inner {fcfg.d_inner}): chunked "
          f"{r['falcon_prefill']['ms']:.4f} ms, {bound_text(scan_bound(fargs, fy, fh))}")
    rows["selective_scan"] = r
    return rows


def phase_e2e(cfg):
    import numpy as np
    import torch

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.core.session import build_real_session
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.models import transformer as T
    from repro_torch.storage.timing import RealExecutor

    from repro_torch.kernels.flash_attention import ops as fa

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da}
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"e2e: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads d_ff {cfg.d_ff} vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.2f} B random {cfg.dtype} weights in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    reset_counts(fa)
    t0 = time.perf_counter()
    sess = build_real_session(cfg, params, prefix, chunk_tokens=CHUNK, in_memory=True,
                              device=DEVICE)
    ingest_s = time.perf_counter() - t0
    ingest_flash = counts(fa)
    if ingest_flash != {"launches": cfg.n_layers, "wgmma": cfg.n_layers}:
        fail(f"ingest: flash_attention launches {ingest_flash}, expected {cfg.n_layers} "
             f"of the wgmma kernel")
    print(f"e2e: ingest of {PREFIX_LEN} tokens took {ingest_s:.2f} s "
          f"(flash_attention launches {ingest_flash})")

    ex = RealExecutor()
    eng = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), ex, budget=BUDGET,
                             period=PERIOD, subperiod=SUBPERIOD)
    n_periods = -(-cfg.n_layers // PERIOD)
    expect = {"chunk_score": n_periods, "chunk_attention": cfg.n_layers,
              "decode_attention": cfg.n_layers * DECODE_TOKENS}
    suffixes = [rng.integers(0, cfg.vocab_size, SUFFIX_LEN) for _ in range(N_REQUESTS)]
    walls = []  # request wall time: first token, then the decode tokens
    reset_counts(*ops.values())
    for i, suffix in enumerate(suffixes):
        before = {k: mod.launches for k, mod in ops.items()}
        busy = dict(ex.stage_times)
        t0 = time.perf_counter()
        logits, trace = eng.reprefill(suffix, request_id=i, decode_tokens=DECODE_TOKENS)
        walls.append((time.perf_counter() - t0) * 1e3)
        got = {k: mod.launches - before[k] for k, mod in ops.items()}
        if got != expect:
            fail(f"request {i}: kernel launches {got}, expected {expect}")
        if trace.read_amplification != 1.0:
            fail(f"request {i}: read amplification {trace.read_amplification}")
        toks = trace.decode_tokens_out
        if (logits.shape != (1, 1, cfg.vocab_size) or not np.isfinite(logits).all()
                or len(toks) != DECODE_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks)):
            fail(f"request {i}: bad output {logits.shape} {toks}")
        print(f"e2e: request {i}: TTFT {trace.ttft * 1e3:.2f} ms, TPOT "
              f"{trace.tpot * 1e3:.3f} ms over {trace.n_decoded} tokens, read "
              f"amplification {trace.read_amplification}, {len(trace.selected_per_layer[0])}"
              f" of {sess.meta.n_chunks} chunks, launches {got}")
        # host clock inside the engine's compute ops (each ends in a device
        # sync) by tag, and the engine's waits on IO; the rest of a request's
        # time is the engine's own bookkeeping
        busy = {k: round((v - busy.get(k, 0.0)) * 1e3, 2) for k, v in ex.stage_times.items()}
        waits = {k: round(v * 1e3, 2) for k, v in trace.stages.items()}
        print(f"e2e: request {i}: compute ops ms {busy}, waits ms {waits}")
    totals = {k: {"dense requests": counts(mod)} for k, mod in ops.items()}
    totals["flash_attention"] = {"dense ingest": ingest_flash}
    print(f"e2e: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    # the profiled request: each wrapper call ran exactly its device kernels
    # (one per decode_attention call; part B's attention pass and merge, and
    # the mass pass for chunk_score alone)
    before = {k: mod.launches for k, mod in ops.items()}
    ours = profile_request(eng, suffixes[0], statistics.mean(walls[1:]))
    got = {k: mod.launches - before[k] for k, mod in ops.items()}
    want = {"chunk_attn_kernel": got["chunk_attention"],
            "chunk_merge_kernel": got["chunk_attention"],
            "decode_kernel": got["decode_attention"],
            "mass_pass_kernel": got["chunk_score"]}
    seen = {k: ours.get(k, (0, 0.0))[0] for k in want}
    if got != expect or seen != want:
        fail(f"profiled request: wrapper launches {got} (expected {expect}), device "
             f"kernels {seen} (expected {want})")
    per_call = {"chunk_attention": {k: seen[k] / got["chunk_attention"]
                                    for k in ("chunk_attn_kernel", "chunk_merge_kernel")},
                "decode_attention": {"decode_kernel": seen["decode_kernel"]
                                     / got["decode_attention"]}}
    print(f"e2e: profiled request: device kernels per wrapper call {per_call} "
          f"(mass_pass_kernel x{seen['mass_pass_kernel']}: chunk_score's alone)")

    # budget 1.0 against the dense forward over prefix + suffix
    full = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                              budget=1.0,
                              period=PERIOD, subperiod=SUBPERIOD)
    logits, _ = full.reprefill(suffixes[0])
    toks = torch.as_tensor(np.concatenate([prefix, suffixes[0]]), device=DEVICE)[None]
    dense = T.forward(params, {"tokens": toks}, cfg, logits_positions="last")
    a = torch.as_tensor(logits[0, -1], device=DEVICE)
    b = dense[0, -1]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    print(f"e2e: budget 1.0 vs dense forward: max abs err / max |logit| {rel:.4f} "
          f"(tol {DENSE_REL_TOL}), cosine {cos:.5f} (min {DENSE_MIN_COS}), argmax "
          f"{int(a.argmax())} vs {int(b.argmax())}")
    if not (rel <= DENSE_REL_TOL and cos >= DENSE_MIN_COS):
        fail("budget-1.0 first-token logits disagree with the dense forward")
    ex.shutdown()
    return totals, per_call


def logit_agreement(a, b):
    """(max abs err / max |b|, cosine) of two logit vectors."""
    import torch

    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return (((a - b).abs().max() / b.abs().max()).item(),
            torch.nn.functional.cosine_similarity(a, b, dim=0).item())


def phase_state_e2e(cfg, n_requests: int, check_decode: bool):
    """StateSpaceEngine on a full-width state-space config: per-request
    launch counts asserted, TTFT/TPOT, compute-op host times, peak memory,
    one profiled request; decode's logits against a prefill over the same
    tokens. Returns {kernel: launches} over the requests."""
    import numpy as np
    import torch

    from repro_torch.core.backends import StateCompute
    from repro_torch.core.engine import StateSpaceEngine
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.models import transformer as T
    from repro_torch.storage.timing import RealExecutor

    ops = {"flash_attention": fa, "selective_scan": ss}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"state: {cfg.name} ({cfg.family}) {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads d_inner {cfg.d_inner} ssm_state "
          f"{cfg.ssm_state} d_ff {cfg.d_ff} vocab {cfg.vocab_size}: {n_params / 1e9:.2f} B "
          f"random {cfg.dtype} weights in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    suffixes = [rng.integers(0, cfg.vocab_size, SUFFIX_LEN) for _ in range(n_requests)]
    be = StateCompute(cfg, params, device=DEVICE)
    ex = RealExecutor()
    eng = StateSpaceEngine(cfg, be, ex, prefix_tokens=prefix)
    L = cfg.n_layers
    # per request: one flash_attention (wgmma) per attention layer of the
    # prefill; one chunked scan per layer of the prefill and one sequential
    # scan per layer and decode token
    expect = {"flash_attention": {"launches": L, "wgmma": L} if cfg.has_attention
              else {"launches": 0},
              "selective_scan": {"launches": L + L * DECODE_TOKENS, "chunked": L,
                                 "sequential": L * DECODE_TOKENS}}
    walls = []
    totals = {k: {} for k in ops}
    for i, suffix in enumerate(suffixes):
        reset_counts(*ops.values())
        busy = dict(ex.stage_times)
        t0 = time.perf_counter()
        logits, trace = eng.reprefill(suffix, request_id=i, decode_tokens=DECODE_TOKENS)
        walls.append((time.perf_counter() - t0) * 1e3)
        got = {k: counts(mod) for k, mod in ops.items()}
        if got != expect:
            fail(f"{cfg.name} request {i}: kernel launches {got}, expected {expect}")
        for k, c in got.items():
            for key, v in c.items():
                totals[k][key] = totals[k].get(key, 0) + v
        toks = trace.decode_tokens_out
        if (logits.shape != (1, 1, cfg.vocab_size) or not np.isfinite(logits).all()
                or len(toks) != DECODE_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks)):
            fail(f"{cfg.name} request {i}: bad output {logits.shape} {toks}")
        busy = {k: round((v - busy.get(k, 0.0)) * 1e3, 2) for k, v in ex.stage_times.items()}
        print(f"state: {cfg.name} request {i}: TTFT {trace.ttft * 1e3:.2f} ms, TPOT "
              f"{trace.tpot * 1e3:.3f} ms over {trace.n_decoded} tokens, launches {got}, "
              f"compute ops ms {busy}")
    print(f"state: {cfg.name} peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    warm = walls[1:] if len(walls) > 1 else walls
    profile_request(eng, suffixes[0], statistics.mean(warm), tag=f"state: {cfg.name}")

    if check_decode:
        prompt = np.concatenate([prefix, suffixes[0]])
        decode_vs_prefill(be, prompt, STEP_BF16_REL_TOL, STEP_BF16_MIN_COS)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = _tree_map(params, lambda t: t.to(torch.float32))
        decode_vs_prefill(StateCompute(cfg32, params32, device=DEVICE), prompt,
                          STEP_REL_TOL, STEP_MIN_COS)
        del params32
    ex.shutdown()
    return totals


def decode_vs_prefill(be, prompt, rel_tol: float, min_cos: float):
    """Decode step k's logits (k = 1, 8) against the last logits of a
    prefill over the prompt and the k greedy tokens fed so far."""
    import numpy as np

    logits, pool = be.prefill(prompt, extra_tokens=DECODE_TOKENS)
    fed, steps = [], {}
    for k in range(1, 9):
        fed.append(int(np.argmax(logits[0, -1])))
        logits, pool.state = be.decode_step(fed[-1], pool.state)
        steps[k] = logits[0, -1]
    for k in (1, 8):
        ref, _ = be.prefill(np.concatenate([prompt, fed[:k]]))
        rel, cos = logit_agreement(steps[k], ref[0, -1])
        print(f"state: {be.cfg.name} {be.cfg.dtype} decode step {k} vs prefill over the same "
              f"{len(prompt) + k} tokens: max abs err / max |logit| {rel:.4f} (tol {rel_tol}), "
              f"cosine {cos:.5f} (min {min_cos}), argmax {int(np.argmax(steps[k]))} vs "
              f"{int(np.argmax(ref[0, -1]))}")
        if not (rel <= rel_tol and cos >= min_cos):
            fail(f"{be.cfg.name} {be.cfg.dtype}: decode step {k} disagrees with the prefill")


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def profile_request(eng, suffix, warm_wall_ms: float, tag: str = "e2e"):
    """One more request under torch.profiler: the device's busy time (sum of
    its kernels and copies, one stream), the idle share against the mean wall
    time of the warm requests run without the profiler (which slows the
    host), and the device operations that take most of the busy time.
    Returns {kernel of this repository: (launches, ms)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.reprefill(suffix, request_id=N_REQUESTS, decode_tokens=DECODE_TOKENS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def device_us(e):  # the attribute's name changed across torch versions
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    dev = [(e.key, e.count, device_us(e)) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(t for _, _, t in dev) / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    top = sorted(dev, key=lambda x: -x[2])[:6]
    print(f"{tag}: profiled request: device busy {busy_ms:.1f} ms of a warm request's "
          f"{warm_wall_ms:.1f} ms ({100 * (1 - busy_ms / warm_wall_ms):.1f} % idle; "
          f"{wall_ms:.1f} ms under the profiler); top device ops: "
          + "; ".join(f"{k[:48]} x{n} {t / 1e3:.2f} ms" for k, n, t in top))
    # the busy time split: this repository's kernels by name, copies, the rest
    ours = {}
    for k, n, t in dev:
        if "ckv::" in k:
            name = k.split("ckv::")[1].split("<")[0].split("(")[0]
            c0, t0 = ours.get(name, (0, 0.0))
            ours[name] = (c0 + n, t0 + t / 1e3)
    copies = sum(t for k, _, t in dev if "Memcpy" in k or "Memset" in k) / 1e3
    mine = sum(t for _, t in ours.values())
    print(f"{tag}: profiled request: busy {busy_ms:.1f} ms = the port's kernels {mine:.2f} "
          f"ms + copies {copies:.2f} ms + other device ops {busy_ms - mine - copies:.2f} ms; "
          "the port's kernels (launches, ms): "
          + ", ".join(f"{k} ({c}, {t:.2f})" for k, (c, t) in sorted(ours.items())))
    return ours


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-7b")
    hcfg, fcfg = get_config("hymba-1.5b"), get_config("falcon-mamba-7b")
    phase_device()
    # the dense phases first, so their requests run in the same process
    # state as before the state-space phases existed
    rows = phase_kernels(cfg)
    paths, per_call = phase_e2e(cfg)
    for name, k in per_call.items():
        rows[name]["device_kernels_per_call"] = k
    torch.cuda.empty_cache()  # the Qwen weights went with phase_e2e
    rows.update(phase_state_kernels(hcfg, cfg, fcfg))
    for name, n in phase_state_e2e(hcfg, N_REQUESTS, check_decode=True).items():
        paths.setdefault(name, {})["hymba-1.5b requests"] = n
    torch.cuda.empty_cache()
    for name, n in phase_state_e2e(fcfg, 1, check_decode=False).items():
        if n["launches"]:
            paths.setdefault(name, {})["falcon-mamba-7b request"] = n
    sources = {"chunk_score": ("src/repro_torch/csrc/chunk_score.cu",
                               "src/repro/kernels/chunk_score/kernel.py:65"),
               "chunk_attention": ("src/repro_torch/csrc/chunk_attention.cu",
                                   "src/repro/kernels/chunk_attention/kernel.py:71"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:77"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:68"),
               "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                                  "src/repro/kernels/selective_scan/kernel.py:55")}
    kernels = []
    for name, r in rows.items():
        launches = sum(p["launches"] for p in paths[name].values())
        if launches < 1:
            fail(f"{name} never launched on the main path")
        row = {"name": name, "route": "cuda", "source": sources[name][0],
               "replaces": sources[name][1], "launches": launches,
               "launches_by_path": paths[name],
               "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound"]["tensor_core"][0],
               "bound_by": r["bound"]["tensor_core"][1],
               "bound_term": r["bound"]["tensor_core"][2],
               "cuda_core_bound_ms": r["bound"]["cuda_core"][0],
               "cuda_core_bound_by": r["bound"]["cuda_core"][1],
               "library_ms": r.get("library_ms")}
        if "tf32" in r["bound"]:
            row["tf32_bound_ms"] = r["bound"]["tf32"][0]
        for key in ("host_ms", "sdpa_output_only_ms", "device_kernels_per_call", "decode_ms",
                    "decode_bound_ms", "falcon_decode_ms", "dense_ingest", "falcon_prefill",
                    "one_cta_per_sm_ms"):
            if key in r:
                row[key] = r[key]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
