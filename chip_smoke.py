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
                (library), and the wrapper's host time per call; for
                chunk_attention and decode_attention also an output-only
                yardstick: one scaled_dot_product_attention call on pre-laid
                contiguous inputs, which computes no mass and which the port
                never calls; then the same at the shapes the baselines give
                them: chunk_score at one token a chunk (d 128, and d 16 for
                IMPRESS's partial keys), chunk_attention at one token a
                chunk over 1024 (and 4096) tokens and at one 64-token block
                a chunk over 64 blocks, decode_attention over 66 pages of 64;
                decode_attention's pools form (b = 4 ragged per-request pools,
                16- and 64-token pages, bfloat16 and float32) against its plain
                version and bit for bit against the stacked form on the padded
                stack, timed beside the stacked call and the pad-and-stack it
                saves;
                chunk_attention's indexed form (b = 1, 2 and 4 members over
                the stacked pool of their gathered chunks, and one member
                over a layer's 256-chunk pool by 64 unsorted indices, 57
                valid) against its plain version and, member by member, bit
                for bit against the gathered call, timed beside the b
                gathered calls it replaces and SDPA at batch b;
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
                part B's attention pass and merge, chunk_score's split pass
                and merge); hold a budget-1.0
                run's first-token logits against the dense forward over
                prefix + suffix;
  4. baselines — on the same weights, prefix and suffixes: ingest a
                coarse-block session (64-token blocks, flash_attention
                launches asserted), serve 3 requests with 16 decode tokens
                through each of AS-LRU, AS-H2O-LFU and IMPRESS (budget 0.25
                where the engine takes one, caches of size 0) with each
                kernel's launches per request, read amplification (1.0 for
                AS-LRU; for the token baselines the value recomputed from
                their selections) and tokens loaded (more than
                ContiguousKV's on the same suffix) asserted; hold
                ContiguousKV w/o P to the full engine bit for bit, AS-LRU
                and a budget-1.0 AS-H2O to the dense forward; profile one
                IMPRESS request as above; print each engine's TTFT and TPOT
                and their TTFT beside ContiguousKV's (this card's in-memory
                store: a record, not the paper's SSD-bound comparison);
  5. serve    — the Scheduler on the dense phase's weights and session: 8
                requests of a 64-token suffix and 16 decode tokens, all
                arriving at 0, FCFS, chunk caches of size 0: (a) c = 4 with
                batched decode (the pools form, one launch per layer per
                batched step), (b) c = 4 unbatched, (c) c = 1, (d) c = 1 with
                SLO preemption and pool swap; (c) and the preempted request
                bit for bit against drive_serial, (a) against (b) (first-token
                logits bit for bit, the first decode step within the dense
                limits), launches by form, no plain version, no pool-sized
                host-to-device copy in (a)'s decode (the torch meter); then
                part B in chunks of 16 suffix tokens at c = 4, (e) with
                batching (each prefill-chunk batch one launch of the indexed
                form, the rest of part B gathered calls) and (f) without:
                (e)'s first-token logits within the dense limits of (f)'s,
                (f) bit for bit (c); part_b_batch held directly on four
                plans' layer-0 final chunks; TTFT,
                TPOT, inter-token latency, tokens/s, batch size, peak memory;
  6. state    — flash_attention (hymba prefill, dense ingest, ragged s,
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
                above (the profiled request's scan kernels held to the
                wrapper's counts per variant); the first request again with
                its prefill in ops of 1024 tokens, bit for bit; decode's
                logits held against a prefill over the same tokens; then one
                request on full-width falcon-mamba-7b (64 layers,
                attention-free); the scan's decode step at b = 2 and 4, both
                widths, held and timed against its bound;
  7. fleet    — the heterogeneous fleet qwen2_5_7b:2,hymba_1_5b:1,
                falcon_mamba_7b:1 on the weights the earlier phases built,
                as serve --fleet builds it (an engine and backend per
                tenant, tenant-namespaced sessions of one more dense ingest,
                its flash_attention launches asserted), every prompt drawn
                below the fleet's smallest vocab (32001): (g) c = 1, one
                request a tenant, first-token logits, last logits and greedy
                tokens bit for bit each engine's drive_serial run alone; (h)
                8 requests (tenant 1 + rid % 4) at c = 8, batched, 8 decode
                tokens: every batch one weight stream, a state-space decode
                batch of two or more, each state-space tenant's step-kernel
                launches = its decode executions x layers (a batched step
                once for its members), the batched first decode steps
                within the state-space decode's bfloat16 limits of (g)'s, no
                plain version; (i) a falcon-mamba and a hymba decode
                preempted with swap: logits and greedy tokens bit for bit
                the uninterrupted run, each leg StatePool.nbytes, the meter
                seeing the swap-in and no pool-sized copy in the decode
                steps; TTFT, TPOT, batches by weight stream, swap bytes and
                time, peak memory;
  8. a ``{"kernels": [...]}`` JSON line with each kernel's launches on the
     paths it names (per variant where a wrapper has several), its error
     against its plain version, its times and its bound (the largest of
     bytes, products and exponentials, named), at the main path's shapes
     and (``baseline_shapes``) at the baselines';
  9. last line: ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero, printing no result, without one or
outside a checkout (it builds and imports ``src/repro_torch``).
"""
from __future__ import annotations

import contextlib
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
# bfloat16/float16 tensor-core rate. The engine's queries and suffix KV are
# float32 from layer 0's part B on, and each kernel is held to 1e-5 of its
# float32 plain version, which bfloat16 operands would miss, so the line also
# gives the bound at the float32 CUDA-core rate; chunk_attention runs its
# products as split-TF32 terms on the tensor cores, so its line also gives the
# bound of those terms at the TF32 rate, and chunk_score runs them as split
# float16 terms (two a product with float32 queries), so its line gives the
# bound of those at the float16 tensor-core rate.
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
# the baselines (AS-LRU, AS-H2O-LFU, IMPRESS): the paper's 64-token blocks,
# IMPRESS's probe of the first d / 8 key dims, requests per engine
BLOCK, IMPRESS_PROBE_RATIO, N_BASELINE_REQUESTS = 64, 0.125, 3
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
# the serve phase: requests, and its preemption scenario's tight TTFT target
# (seconds) and prefill-time floor, which make the urgent request project a
# miss whatever the EWMA reads
SERVE_REQUESTS, SERVE_TTFT_TARGET, SERVE_PREFILL_FLOOR = 8, 1e-6, 10.0
# chunked prefill: the serve phase's part B in ops of 16 suffix tokens, the
# state-space request's prefill in ops of 1024 tokens; the indexed form's
# paged case: valid chunks of the 64 indices into a layer's pool
SERVE_PREFILL_CHUNK, STATE_PREFILL_CHUNK, INDEXED_PAGED_VALID = 16, 1024, 57
# the heterogeneous fleet: tenants by model, requests (tenant 1 + rid % 4, so
# two a tenant) and decode tokens each
FLEET_SPEC, FLEET_REQUESTS, FLEET_DECODE = "qwen2_5_7b:2,hymba_1_5b:1,falcon_mamba_7b:1", 8, 8
# a batched part B's h against the single one's: the same attention bit for
# bit, then float32 GEMMs over b * 64 rows instead of 64, which cuBLAS may
# sum in another order (sums of 3584 and 18944 products): a few float32
# ulps of the largest value are expected, 1e-5 of it is the kernels' limit
PART_B_BATCH_REL = 1e-5
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


def bounds(nbytes: float, ops: float, exps: float, tf32_ops: float | None = None,
           f16_split_ops: float | None = None):
    """{"tensor_core" | "cuda_core" [| "tf32" | "f16_split"]: (least ms,
    "bytes" | "operations", term)} on the H100: the largest of the bytes over
    the memory rate, the products at either rate, and the exponentials over
    the special-function units' rate; ``term`` names it ("bytes", "products"
    or "exponentials", the last two being operations). ``tf32_ops`` counts
    the products of split-TF32 terms, at the TF32 rate; ``f16_split_ops``
    those of split float16 terms, at the float16 tensor-core rate."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "exponentials": exps / EXP_PER_S * 1e3}
    out = {}
    rates = [("tensor_core", ops, TENSOR_CORE_OPS_PER_S),
             ("cuda_core", ops, CUDA_CORE_FP32_OPS_PER_S)]
    if tf32_ops is not None:
        rates.append(("tf32", tf32_ops, TF32_OPS_PER_S))
    if f16_split_ops is not None:
        rates.append(("f16_split", f16_split_ops, TENSOR_CORE_OPS_PER_S))
    for name, n_ops, rate in rates:
        t = dict(terms, products=n_ops / rate * 1e3)
        term = max(t, key=t.get)
        out[name] = (t[term], "bytes" if term == "bytes" else "operations", term)
    return out


def bound_text(bound) -> str:
    tc, cc = bound["tensor_core"], bound["cuda_core"]
    text = (f"bound {tc[0]:.5f} ms by {tc[2]} at the tensor-core rate, {cc[0]:.5f} ms by "
            f"{cc[2]} at the float32 CUDA-core rate")
    if "f16_split" in bound:
        text += (f", {bound['f16_split'][0]:.5f} ms by {bound['f16_split'][2]} for its split "
                 f"float16 terms")
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


def phase_device() -> str:
    """Prints and returns the card's name and power limit (nvidia-smi)."""
    global EXP_PER_S
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
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
    return smi_line


def phase_kernels(cfg):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

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
            # float32 q: q_lo k + q_hi k, two split float16 products per term
            rows["chunk_score"] = dict(
                err=err, ms=device_ms(lambda: chunk_score(q, kk, CHUNK)),
                host_ms=host_ms(lambda: chunk_score(q, kk, CHUNK)),
                plain_ms=wall_ms(lambda: chunk_score_ref(q, kk, CHUNK)),
                bound=bounds(nbytes(q, kk) + 4 * m, 2.0 * s * nq * n * d, s * nq * n,
                             f16_split_ops=2 * 2.0 * s * nq * n * d))

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
            rows["chunk_attention"] = chunk_attention_timing(q, ks, vs, n_valid, kf, vf, o, ms,
                                                             err)

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
    rows["decode_attention"] = decode_attention_timing(q, kp, vp, wide, lens, o, pm,
                                                       max(err_o, err_m))
    print("kernels: decode_attention two runs bit-identical")
    for name, r in rows.items():
        extra = f"; host time per call {r['host_ms']:.4f} ms"
        if "sdpa_output_only_ms" in r:
            extra += (f"; output-only scaled_dot_product_attention "
                      f"{r['sdpa_output_only_ms']:.4f} ms")
        print(f"kernels: {name}: {r['ms']:.4f} ms on the card (plain version "
              f"{r['plain_ms']:.4f} ms, {bound_text(r['bound'])}, "
              f"library call: none returns the per-chunk/page mass{extra})")
    return rows


def phase_baseline_kernels(cfg):
    """The three attention kernels at the shapes the baselines give them,
    each against its plain version with the main path's tolerances, timed:
    chunk_score at one token a chunk over the whole prefix (AS-H2O's d 128
    and IMPRESS's partial keys, d 16); chunk_attention at one token a chunk
    over the budget's 1024 tokens (and all 4096, budget 1.0, checked only)
    and at one 64-token block a chunk over all 64 blocks (AS-LRU);
    decode_attention over AS-LRU's last decode step's pool of 64 resident
    blocks and 2 tail pages of 64 tokens. Returns {kernel: {shape: numbers}}."""
    import torch

    from repro_torch.kernels.chunk_attention.ops import chunk_attention
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.chunk_score.ops import chunk_score
    from repro_torch.kernels.chunk_score.ref import chunk_score_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s, nq, nkv, d = SUFFIX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    n = PREFIX_LEN
    out = {"chunk_score": {}, "chunk_attention": {}, "decode_attention": {}}
    # chunk_score at c = 1: float32 q past layer 0, bfloat16 q at layer 0
    d_probe = int(d * IMPRESS_PROBE_RATIO)
    for dd in (d, d_probe):
        for qdt in (torch.float32, torch.bfloat16):
            q, kk = rn(s, nq, dd, dtype=qdt), rn(n, nkv, dd, dtype=torch.float16)
            got, ref = chunk_score(q, kk, 1), chunk_score_ref(q, kk, 1)
            err, tol = max_err(got, ref), 1e-5 * ref.abs().max().item() + 1e-6
            if not err <= tol:
                fail(f"chunk_score c=1 d={dd} {dname(q)}: max abs err {err} > {tol}")
            if not torch.equal(got, chunk_score(q, kk, 1)):
                fail(f"chunk_score c=1 d={dd} is not reproducible bit for bit")
            n_ops = 2.0 * s * nq * n * dd
            r = dict(err=err, ms=device_ms(lambda: chunk_score(q, kk, 1)),
                     host_ms=host_ms(lambda: chunk_score(q, kk, 1)),
                     plain_ms=wall_ms(lambda: chunk_score_ref(q, kk, 1)),
                     bound=bounds(nbytes(q, kk) + 4 * n, n_ops, s * nq * n,
                                  f16_split_ops=(2 if qdt == torch.float32 else 1) * n_ops))
            out["chunk_score"][f"c1_d{dd}_{dname(q)}"] = r
            print(f"kernels: chunk_score c=1 (token scores) d={dd} q {dname(q)}: max abs err "
                  f"{err:.3g} (tol {tol:.3g}), two runs bit-identical; {r['ms']:.4f} ms on the "
                  f"card (plain version {r['plain_ms']:.4f} ms, {bound_text(r['bound'])}, "
                  f"host time per call {r['host_ms']:.4f} ms)")

    # chunk_attention: the token baselines' part B (c = 1; every token at
    # budget 1.0) and AS-LRU's (c = 64), every bucket slot valid
    for c, nb in ((1, 1024), (1, 4096), (BLOCK, n // BLOCK)):
        ks, vs = (rn(nb, c, nkv, d, dtype=torch.float16) for _ in range(2))
        for qdt in (torch.float32, torch.bfloat16):
            q, kf, vf = (rn(s, nq, d, dtype=qdt), rn(s, nkv, d, dtype=qdt),
                         rn(s, nkv, d, dtype=qdt))
            (o, ms), (o2, ms2) = (chunk_attention(q, ks, vs, nb, kf, vf),
                                  chunk_attention_ref(q, ks, vs, nb, kf, vf))
            err = max(max_err(o, o2), max_err(ms, ms2))
            tol = 1e-5 * max(o2.abs().max().item(), ms2.abs().max().item()) + 1e-6
            if not err <= tol:
                fail(f"chunk_attention c={c} chunks {nb} {dname(q)}: err {err} > {tol}")
            again = chunk_attention(q, ks, vs, nb, kf, vf)
            if not (torch.equal(o, again[0]) and torch.equal(ms, again[1])):
                fail(f"chunk_attention c={c} is not reproducible bit for bit")
            print(f"kernels: chunk_attention c={c} q {dname(q)} chunks {nb}/{nb}: max abs err "
                  f"{err:.3g} (tol {tol:.3g}) on out and A_j, two runs bit-identical")
            if qdt == torch.float32 and nb != 4096:
                r = chunk_attention_timing(q, ks, vs, nb, kf, vf, o, ms, err)
                out["chunk_attention"][f"c{c}_chunks{nb}"] = r
                print(f"kernels: chunk_attention c={c} chunks {nb}: {r['ms']:.4f} ms on the "
                      f"card (plain version {r['plain_ms']:.4f} ms, {bound_text(r['bound'])}, "
                      f"host time per call {r['host_ms']:.4f} ms, output-only "
                      f"scaled_dot_product_attention {r['sdpa_output_only_ms']:.4f} ms)")

    # decode_attention: AS-LRU's pool at its last decode step, bfloat16
    n_res, n_tail = n // BLOCK, -(-(s + DECODE_TOKENS) // BLOCK)
    q = rn(1, nq, d, dtype=torch.bfloat16)
    kp, vp = (rn(1, n_res + n_tail, BLOCK, nkv, d, dtype=torch.bfloat16) for _ in range(2))
    table = torch.arange(n_res + n_tail, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([n + s + DECODE_TOKENS], dtype=torch.int32, device=dev)
    (o, pm), (o2, pm2) = (decode_attention(q, kp, vp, table, lens),
                          decode_attention_ref(q, kp, vp, table, lens))
    err_o, tol_o = max_err(o, o2), 2.0 ** -7 * o2.float().abs().max().item()
    err_m, tol_m = max_err(pm, pm2), 1e-5 * pm2.abs().max().item() + 1e-7
    if not (err_o <= tol_o and err_m <= tol_m):
        fail(f"decode_attention page {BLOCK}: err out {err_o} > {tol_o} or mass {err_m} > {tol_m}")
    again = decode_attention(q, kp, vp, table, lens)
    if not (torch.equal(o, again[0]) and torch.equal(pm, again[1])):
        fail(f"decode_attention page {BLOCK} is not reproducible bit for bit")
    r = decode_attention_timing(q, kp, vp, table, lens, o, pm, max(err_o, err_m))
    out["decode_attention"][f"page{BLOCK}_pages{n_res + n_tail}"] = r
    print(f"kernels: decode_attention bfloat16 {n_res + n_tail} pages of {BLOCK}: max abs err "
          f"out {err_o:.3g} (tol {tol_o:.3g}), mass {err_m:.3g} (tol {tol_m:.3g}), two runs "
          f"bit-identical; {r['ms']:.4f} ms on the card (plain version {r['plain_ms']:.4f} ms, "
          f"{bound_text(r['bound'])}, host time per call {r['host_ms']:.4f} ms, output-only "
          f"scaled_dot_product_attention {r['sdpa_output_only_ms']:.4f} ms)")
    return out


def chunk_attention_timing(q, ks, vs, n_valid, kf, vf, o, ms, err) -> dict:
    """One chunk_attention shape's numbers for the kernels line: device, host
    and plain times, the output-only yardstick (float32 SDPA over pre-laid
    [chunks ; suffix] with a boolean mask: chunks visible, the suffix causal)
    over the same keys, and the bound (float32 queries: the split-TF32 terms
    are two a chunk product and three a suffix product)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.chunk_attention.ops import chunk_attention
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref

    s, nq, d = q.shape
    _, c, nkv, _ = ks.shape
    pairs_c, pairs_s = s * n_valid * c, s * (s + 1) // 2
    pairs = pairs_c + pairs_s

    def call():
        return chunk_attention(q, ks, vs, n_valid, kf, vf)
    n_pre = n_valid * c
    k_all, v_all = (torch.cat([x[:n_valid].reshape(n_pre, nkv, d).to(y.dtype), y])
                    .permute(1, 0, 2)[None].contiguous() for x, y in ((ks, kf), (vs, vf)))
    q_t = q.permute(1, 0, 2)[None].contiguous()
    mask = torch.ones(s, n_pre + s, dtype=torch.bool, device=q.device)
    mask[:, n_pre:] = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()

    def sdpa():
        return F.scaled_dot_product_attention(q_t, k_all, v_all, attn_mask=mask, enable_gqa=True)
    sdpa_err = max_err(sdpa()[0].permute(1, 0, 2), o)
    print(f"kernels: chunk_attention c={c} chunks {n_valid}: output-only yardstick "
          f"scaled_dot_product_attention ({dname(q)}, boolean mask, {n_pre + s} keys; computes "
          f"no A_j, the port never calls it) agrees to {sdpa_err:.3g}")
    return dict(err=err, ms=device_ms(call), host_ms=host_ms(call),
                plain_ms=wall_ms(lambda: chunk_attention_ref(q, ks, vs, n_valid, kf, vf)),
                sdpa_output_only_ms=device_ms(sdpa),
                bound=bounds(nbytes(q, kf, vf, o, ms, ks[:n_valid], vs[:n_valid]),
                             4.0 * nq * d * pairs, nq * pairs,
                             tf32_ops=4.0 * nq * d * (2 * pairs_c + 3 * pairs_s)))


def decode_attention_timing(q, kp, vp, table, lens, o, pm, err) -> dict:
    """One decode_attention shape's numbers for the kernels line: device,
    host and plain times, the output-only yardstick (SDPA over the valid
    tokens laid out contiguously, in q's dtype) and the bound (each valid
    token's K and V read once)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    _, nq, d = q.shape
    _, _, page, nkv, _ = kp.shape
    L = int(lens.item())
    n_full = -(-L // page)  # the table's first n_full slots hold the valid tokens in order

    def call():
        return decode_attention(q, kp, vp, table, lens)
    k_c, v_c = (x[0, table[0, :n_full].long()].reshape(-1, nkv, d)[:L].permute(1, 0, 2)[None]
                .contiguous() for x in (kp, vp))
    q_c = q[:, :, None]

    def sdpa():
        return F.scaled_dot_product_attention(q_c, k_c, v_c, enable_gqa=True)
    sdpa_err = max_err(sdpa()[:, :, 0], o)
    print(f"kernels: decode_attention page {page}, {L} tokens: output-only yardstick "
          f"scaled_dot_product_attention ({dname(q)}, enable_gqa; computes no per-page mass, "
          f"the port never calls it) agrees to {sdpa_err:.3g}")
    return dict(err=err, ms=device_ms(call), host_ms=host_ms(call),
                plain_ms=wall_ms(lambda: decode_attention_ref(q, kp, vp, table, lens)),
                sdpa_output_only_ms=device_ms(sdpa),
                bound=bounds(nbytes(q, o, pm, table, lens) + 2 * L * nkv * d * kp.element_size(),
                             4.0 * nq * d * L, nq * L))


def phase_pools_kernels(cfg):
    """decode_attention's pools form at b = 4 over ragged per-request pools:
    16-token pages at the dense path's shapes (each pool its 64 resident
    chunk pages and up to 5 tail pages, as the serve phase's batched steps
    give them) and 64-token pages (the baselines' blocks), bfloat16 as
    served and float32. Each case against its plain version at the main
    path's tolerances and bit for bit against the stacked kernel on the
    zero-padded stack at the same table width; timed beside the stacked call
    and the plain pad-and-stack the pools form saves. The timed call takes
    its pointer block already on the card, as the batched decode step gives
    it (one upload a step for every layer); a call that uploads its own
    block (from pageable host memory, which waits for the stream) is timed
    on the host beside it. Returns {case: numbers}."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention.ops import (PoolPointers, decode_attention,
                                                          decode_attention_pools, pool_pointers)
    from repro_torch.kernels.decode_attention.ref import (decode_attention_pools_ref,
                                                          stack_pool_buffers)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    nq, nkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    n_res = math.ceil(BUDGET * (PREFIX_LEN // CHUNK))
    cap = -(-(SUFFIX_LEN + DECODE_TOKENS) // CHUNK)
    cases = {  # page: (pages of each pool, table slots in use)
        CHUNK: ([n_res + cap, n_res + cap, n_res + cap - 3, n_res + cap - 9],
                [n_res + cap - 1, n_res + cap, n_res + cap - 4, n_res + cap - 9]),
        BLOCK: ([66, 66, 60, 50], [66, 65, 60, 49]),
    }
    out = {}
    for page, (n_pages, n_active) in cases.items():
        width = max(n_pages)
        for dtype in (torch.bfloat16, torch.float32):
            def rn(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            q = rn(4, nq, d)
            ks = [rn(n, page, nkv, d) for n in n_pages]
            vs = [rn(n, page, nkv, d) for n in n_pages]
            tbl = torch.full((4, width), -1, dtype=torch.int32, device=dev)
            for i, n in enumerate(n_active):
                tbl[i, :n] = torch.arange(n, dtype=torch.int32, device=dev)
            lens = torch.tensor([(n - 1) * page + 1 + 5 * i for i, n in enumerate(n_active)],
                                dtype=torch.int32, device=dev)
            o, pm = decode_attention_pools(q, ks, vs, tbl, lens)
            o2, pm2 = decode_attention_pools_ref(q, ks, vs, tbl, lens)
            rel_o = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
            err_o, tol_o = max_err(o, o2), rel_o * o2.float().abs().max().item() + 1e-6
            err_m, tol_m = max_err(pm, pm2), 1e-5 * pm2.abs().max().item() + 1e-7
            if not (err_o <= tol_o and err_m <= tol_m):
                fail(f"decode_attention_pools page {page} {dname(q)}: err out {err_o} > {tol_o} "
                     f"or mass {err_m} > {tol_m}")
            if pm[tbl[:, None, :].expand_as(pm) < 0].abs().max().item() != 0.0:
                fail(f"decode_attention_pools page {page}: mass on a pad slot")
            kp, vp = stack_pool_buffers(ks, vs)
            os_, pms = decode_attention(q, kp, vp, tbl, lens)
            again = decode_attention_pools(q, ks, vs, tbl, lens)
            if not (torch.equal(o, os_) and torch.equal(pm, pms) and torch.equal(o, again[0])
                    and torch.equal(pm, again[1])):
                fail(f"decode_attention_pools page {page} {dname(q)}: not bit-identical to the "
                     f"stacked kernel on the padded stack, or to itself")
            L = int(lens.sum().item())
            host = pool_pointers(ks, vs)
            ptrs = PoolPointers(host, torch.from_numpy(host).to(dev))
            r = dict(err=max(err_o, err_m),
                     ms=device_ms(lambda: decode_attention_pools(q, ks, vs, tbl, lens, ptrs)),
                     stacked_ms=device_ms(lambda: decode_attention(q, kp, vp, tbl, lens)),
                     pad_stack_ms=device_ms(lambda: stack_pool_buffers(ks, vs)),
                     host_ms=host_ms(lambda: decode_attention_pools(q, ks, vs, tbl, lens, ptrs)),
                     own_upload_wall_ms=wall_ms(
                         lambda: decode_attention_pools(q, ks, vs, tbl, lens)),
                     plain_ms=wall_ms(lambda: decode_attention_pools_ref(q, ks, vs, tbl, lens)),
                     library_ms=None,
                     # each valid token's K and V read once, q, the table,
                     # lengths and the pointer block read, out and mass written
                     bound=bounds(nbytes(q, o, pm, tbl, lens) + 3 * 4 * 8
                                  + 2 * L * nkv * d * q.element_size(), 4.0 * nq * d * L, nq * L))
            out[f"page{page}_b4_{dname(q)}"] = r
            print(f"kernels: decode_attention_pools b=4 page {page} {dname(q)} pools of "
                  f"{n_pages} pages, {n_active} slots in use: max abs err out {err_o:.3g} (tol "
                  f"{tol_o:.3g}), mass {err_m:.3g} (tol {tol_m:.3g}); bit-identical to the "
                  f"stacked kernel on the padded stack; {r['ms']:.4f} ms on the card, stacked "
                  f"call {r['stacked_ms']:.4f} ms + its pad-and-stack {r['pad_stack_ms']:.4f} ms,"
                  f" plain version {r['plain_ms']:.4f} ms, {bound_text(r['bound'])}, host time "
                  f"per call {r['host_ms']:.4f} ms (a call uploading its own pointer block: "
                  f"{r['own_upload_wall_ms']:.4f} ms to a synchronize), library call: none "
                  f"returns per-page mass")
    return out


def phase_indexed_kernels(cfg):
    """chunk_attention's indexed form at the main path's shape (28/4 heads, d
    128, s 64, 64 chunks of 16), float32 and bfloat16 q: b = 1, 2 and 4
    members over the stacked pool of their gathered chunks (as part_b_batch
    gives it), and the reference's paged shape (one member over a layer's
    256-chunk pool, 64 unsorted indices, INDEXED_PAGED_VALID of them valid).
    Each against its plain version at the main path's tolerance and, member
    by member, bit for bit against the gathered call on pool[chunk_idx[i]];
    timed beside the b gathered calls it replaces, with its bound, the
    wrapper's host time and the output-only SDPA yardstick at batch b.
    Returns {case: numbers}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.chunk_attention.ops import (chunk_attention,
                                                         chunk_attention_indexed)
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_indexed_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s, nq, nkv, d, c = SUFFIX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, CHUNK
    n_sel = math.ceil(BUDGET * (PREFIX_LEN // CHUNK))
    cases = [(f"b{b}", b, b * n_sel) for b in (1, 2, 4)] + [("paged", 1, PREFIX_LEN // CHUNK)]
    out = {}
    for label, b, m in cases:
        pool_k, pool_v = (rn(m, c, nkv, d, dtype=torch.float16) for _ in range(2))
        if label == "paged":  # unsorted indices into the whole layer's pool
            perm = torch.randperm(m, generator=gen, device=dev)[:n_sel]
            idx = perm.to(torch.int32)[None].contiguous()
            n_valid = [INDEXED_PAGED_VALID]
        else:  # member i's chunks are rows i n_sel .. of the stacked pool
            idx = torch.arange(b * n_sel, dtype=torch.int32, device=dev).view(b, n_sel)
            n_valid = [n_sel] * b
        nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        for qdt in (torch.float32, torch.bfloat16):
            q, kf, vf = rn(b, s, nq, d, dtype=qdt), rn(b, s, nkv, d, dtype=qdt), rn(
                b, s, nkv, d, dtype=qdt)
            o, ms = chunk_attention_indexed(q, pool_k, pool_v, idx, nv, kf, vf)
            o2, ms2 = chunk_attention_indexed_ref(q, pool_k, pool_v, idx, nv, kf, vf)
            err = max(max_err(o, o2), max_err(ms, ms2))
            tol = 1e-5 * max(o2.abs().max().item(), ms2.abs().max().item()) + 1e-6
            if not err <= tol or o.dtype != torch.float32:
                fail(f"chunk_attention_indexed {label} {dname(q)}: err {err} > {tol}")
            sel = [(pool_k[idx[i].long()].contiguous(), pool_v[idx[i].long()].contiguous())
                   for i in range(b)]
            for i, (ks, vs) in enumerate(sel):
                go, gm = chunk_attention(q[i], ks, vs, n_valid[i], kf[i], vf[i])
                if not (torch.equal(o[i], go) and torch.equal(ms[i], gm)):
                    fail(f"chunk_attention_indexed {label} {dname(q)}: member {i} differs from "
                         f"the gathered call on its chunks")
            again = chunk_attention_indexed(q, pool_k, pool_v, idx, nv, kf, vf)
            if not (torch.equal(o, again[0]) and torch.equal(ms, again[1])):
                fail(f"chunk_attention_indexed {label} is not reproducible bit for bit")

            def call():
                return chunk_attention_indexed(q, pool_k, pool_v, idx, nv, kf, vf)

            def gathered():
                return [chunk_attention(q[i], ks, vs, n_valid[i], kf[i], vf[i])
                        for i, (ks, vs) in enumerate(sel)]
            n_pre = n_valid[0] * c  # every member has as many valid chunks
            k_all, v_all = (torch.cat([torch.stack([x[:n_valid[0]].reshape(n_pre, nkv, d)
                                                    for x in xs]).to(y.dtype), y], 1)
                            .permute(0, 2, 1, 3).contiguous()
                            for xs, y in (([k for k, _ in sel], kf), ([v for _, v in sel], vf)))
            q_t = q.permute(0, 2, 1, 3).contiguous()
            mask = torch.ones(s, n_pre + s, dtype=torch.bool, device=dev)
            mask[:, n_pre:] = torch.ones(s, s, dtype=torch.bool, device=dev).tril()

            def sdpa():
                return F.scaled_dot_product_attention(q_t, k_all, v_all, attn_mask=mask,
                                                      enable_gqa=True)
            pairs_c, pairs_s = b * s * n_pre, b * s * (s + 1) // 2
            pairs = pairs_c + pairs_s
            # split-TF32 terms: a float32 q 2 a chunk product, 3 a suffix one
            # (QK and PV alike); a bfloat16 q 1 a QK product, 2 a PV one
            terms = (4.0 * nq * d * (2 * pairs_c + 3 * pairs_s) if qdt == torch.float32
                     else 6.0 * nq * d * pairs)
            r = dict(err=err, ms=device_ms(call), gathered_calls_ms=device_ms(gathered),
                     host_ms=host_ms(call),
                     plain_ms=wall_ms(lambda: chunk_attention_indexed_ref(
                         q, pool_k, pool_v, idx, nv, kf, vf)),
                     sdpa_output_only_ms=device_ms(sdpa), library_ms=None,
                     # q, suffix KV, the valid chunks, indices and counts read
                     # once; out and A_j written once
                     bound=bounds(nbytes(q, kf, vf, o, ms, idx, nv)
                                  + 2 * sum(n_valid) * c * nkv * d * 2,
                                  4.0 * nq * d * pairs, nq * pairs, tf32_ops=terms))
            out[f"{label}_{dname(q)}"] = r
            print(f"kernels: chunk_attention_indexed {label} b={b} q {dname(q)} pool {m} chunks, "
                  f"{n_valid} of {n_sel} valid: max abs err {err:.3g} (tol {tol:.3g}) on out and "
                  f"A_j, each member bit-identical to the gathered call on its chunks; "
                  f"{r['ms']:.4f} ms on the card against {r['gathered_calls_ms']:.4f} ms for the "
                  f"{b} gathered call(s), plain version {r['plain_ms']:.4f} ms, "
                  f"{bound_text(r['bound'])}, host time per call {r['host_ms']:.4f} ms, "
                  f"output-only scaled_dot_product_attention at batch {b} "
                  f"{r['sdpa_output_only_ms']:.4f} ms (agrees to "
                  f"{max_err(sdpa().permute(0, 2, 1, 3), o):.3g})")
    return out


@contextlib.contextmanager
def plain_versions_counted(ops):
    """Count every call of a plain version a wrapper in ``ops`` could run:
    yields {name: calls}, which the caller clears before each run."""
    plain_calls = {}
    saved = {(mod, n): getattr(mod, n) for mod in ops.values() for n in vars(mod)
             if n.endswith("_ref")}
    for (mod, name), f in saved.items():
        def counted(*a, _f=f, _n=name, **kw):
            plain_calls[_n] = plain_calls.get(_n, 0) + 1
            return _f(*a, **kw)
        setattr(mod, name, counted)
    try:
        yield plain_calls
    finally:
        for (mod, name), f in saved.items():
            setattr(mod, name, f)


def _tap(gen, rec, vocab):
    """Forward a plan's generator, recording its first-token logits (the
    dense path's, or the state-space prefill's with its pool) and each
    decode step's."""
    import numpy as np

    from repro_torch.core.backends import StatePool

    send = None
    while True:
        try:
            op = gen.send(send)
        except StopIteration as stop:
            return stop.value
        send = yield op
        if getattr(op, "phase", None) == "decode":
            rec.setdefault("steps", []).append(send[0] if isinstance(send, tuple) else send)
        elif isinstance(send, tuple) and len(send) == 2 and isinstance(send[1], StatePool):
            rec["first"], rec["pool"] = send
        elif ("first" not in rec and isinstance(send, np.ndarray)
              and send.shape == (1, 1, vocab)):
            rec["first"] = send


def _tapped(eng):
    """Have ``eng.plan`` tap every plan; returns {request_id: taps}."""
    taps = {}
    plan = eng.plan

    def tapped(suffix, request_id=0, decode_tokens=0):
        p = plan(suffix, request_id, decode_tokens=decode_tokens)
        p.gen = _tap(p.gen, taps.setdefault(request_id, {}), eng.cfg.vocab_size)
        return p

    eng.plan = tapped
    return taps


def phase_serve(cfg, ctx, smi_line):
    """The Scheduler on the dense phase's weights and 4096-token session
    (budget 0.25, period 8, subperiod 4, caches of size 0, so every run is
    independent of history): SERVE_REQUESTS requests of a 64-token suffix and
    16 decode tokens, all arriving at 0, FCFS. (a) c = 4 batched, (b) c = 4
    unbatched, (c) c = 1, (d) c = 1 with SLO preemption and pool swap, held
    as the module docstring says. Returns {kernel: {path: launches}}."""
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da,
           "flash_attention": fa, "selective_scan": ss}
    with plain_versions_counted(ops) as plain_calls:
        return _serve_runs(cfg, ctx, smi_line, ops, plain_calls)


def _serve_runs(cfg, ctx, smi_line, ops, plain_calls):
    import numpy as np
    import torch

    from repro_torch.core.backends import DeviceTailPool, RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.serving import Request, Scheduler, summarize
    from repro_torch.storage.h2d_meter import H2DMeter
    from repro_torch.storage.timing import RealExecutor

    L, V = cfg.n_layers, cfg.vocab_size
    params, sess = ctx["params"], ctx["sess"]
    rng = np.random.default_rng(7)
    suffixes = [rng.integers(0, V, SUFFIX_LEN) for _ in range(SERVE_REQUESTS)]

    def engine(chunk=None):
        return ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                                  budget=BUDGET, period=PERIOD, subperiod=SUBPERIOD,
                                  prefill_chunk_tokens=chunk)

    # drive_serial, the reference of (c) and (d)
    eng = engine()
    ref_taps = _tapped(eng)
    refs = [eng.reprefill(sfx, request_id=i, decode_tokens=DECODE_TOKENS)
            for i, sfx in enumerate(suffixes)]
    eng.ex.shutdown()
    pool_bytes = 2 * (len(refs[0][1].selected_per_layer[0]) + -(-(SUFFIX_LEN + DECODE_TOKENS)
                                                                // CHUNK)) \
        * CHUNK * cfg.n_kv_heads * cfg.d_head * 2  # K and V of one layer's pool, bfloat16

    def serve(label, max_c, batch=True, n=SERVE_REQUESTS, preempt=False, meter=False,
              chunk=None):
        eng = engine(chunk)
        taps = _tapped(eng)
        transfers = []
        if meter:  # the decode steps' host-to-device transfers, by the torch meter
            be = eng.backend
            for name in ("decode_step_batch", "decode_attend"):
                def metered(*a, _f=getattr(be, name), **kw):
                    with H2DMeter(DEVICE) as m:
                        out = _f(*a, **kw)
                    transfers.extend(m.transfers)
                    return out
                setattr(be, name, metered)
        reqs = [Request(request_id=i, suffix=suffixes[i], decode_tokens=DECODE_TOKENS,
                        ttft_target=SERVE_TTFT_TARGET if preempt and i == 1 else None)
                for i in range(n)]
        sched = Scheduler(eng, policy="fcfs", max_concurrency=max_c, batch_decode=batch,
                          preempt=preempt, swap_on_preempt=preempt,
                          prefill_estimate=SERVE_PREFILL_FLOOR if preempt else None)
        reset_counts(*ops.values())
        plain_calls.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stage_ms = {k: round(v * 1e3, 1) for k, v in eng.ex.stage_times.items()}
        eng.ex.shutdown()
        got = {k: counts(mod) for k, mod in ops.items()}
        if len(done) != n or [c.request.request_id for c in done] != list(range(n)):
            fail(f"serve {label}: {len(done)} of {n} requests completed")
        for c in done:
            toks = c.trace.decode_tokens_out
            if (c.result.shape != (1, 1, V) or not np.isfinite(c.result).all()
                    or len(toks) != DECODE_TOKENS or not all(0 <= t < V for t in toks)):
                fail(f"serve {label} request {c.request.request_id}: bad output")
        if plain_calls:
            fail(f"serve {label}: plain versions ran on the card: {plain_calls}")
        s = summarize(done)
        sizes = [len(m) for m in sched.real_batch_log]
        s.update(mean_batch=float(np.mean(sizes)) if sizes else 1.0,
                 batched_iterations=len(sizes), wall_s=wall,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"serve {label}: {n} requests, p50 TTFT {s['p50_ttft'] * 1e3:.2f} ms, p95 TTFT "
              f"{s['p95_ttft'] * 1e3:.2f} ms, mean TPOT {s['mean_tpot'] * 1e3:.3f} ms, p95 ITL "
              f"{s['p95_itl'] * 1e3:.3f} ms, {s['decode_tok_rate']:.2f} decode tokens/s, goodput "
              f"{s['goodput_rps']:.3f} req/s, makespan {s['makespan']:.3f} s, mean batch "
              f"{s['mean_batch']:.2f} over {len(sizes)} batched iterations, peak device memory "
              f"{s['peak_gib']:.2f} GiB, wall {wall:.3f} s of which compute ops ms by tag "
              f"{stage_ms}, launches {got} ({smi_line})")
        return done, sched, taps, got, s, transfers

    paths = {}

    def record(label, got):
        for k, c in got.items():
            if c["launches"]:
                paths.setdefault(k, {})[f"serve {label}"] = c

    # (a) batched, (b) unbatched, both metered alike
    done_a, sched_a, taps_a, got_a, s_a, tr_a = serve("(a) c=4 batched", 4, meter=True)
    done_b, _, taps_b, got_b, s_b, _ = serve("(b) c=4 unbatched", 4, batch=False, meter=True)
    record("(a) c=4 batched", got_a)
    record("(b) c=4 unbatched", got_b)
    batches = sched_a.real_batch_log
    if not batches or min(len(m) for m in batches) < 2:
        fail(f"serve (a): batched iterations {[len(m) for m in batches]}")
    members = sum(len(m) for m in batches)
    want = {"pools": len(batches) * L,
            "stacked": (SERVE_REQUESTS * DECODE_TOKENS - members) * L}
    by_form = {k: got_a["decode_attention"].get(k, 0) for k in want}
    if by_form != want:
        fail(f"serve (a): decode_attention launches by form {by_form}, expected {want}")
    if got_b["decode_attention"].get("pools", 0):
        fail("serve (b): the pools form ran without batching")
    if not tr_a or max(n for _, n in tr_a) >= pool_bytes // 2:
        fail(f"serve (a): a decode-step host-to-device copy of {max(n for _, n in tr_a)} B, "
             f"not below one {pool_bytes // 2} B pool buffer")
    steps = SERVE_REQUESTS * DECODE_TOKENS
    print(f"serve (a): {len(batches)} batched iterations of {[len(m) for m in batches]} "
          f"members; decode_attention launches by form {by_form}; decode steps' "
          f"host-to-device transfers by the torch meter: {len(tr_a)}, largest "
          f"{max(n for _, n in tr_a)} B, {sum(n for _, n in tr_a) / steps:.0f} B a decode token "
          f"(one pool buffer {pool_bytes // 2} B)")
    agree = 0
    worst = (0.0, 1.0)
    for i in range(SERVE_REQUESTS):
        ta, tb = taps_a[i], taps_b[i]
        if not np.array_equal(ta["first"], tb["first"]):
            fail(f"serve request {i}: first-token logits differ between (a) and (b)")
        rel, cos = logit_agreement(ta["steps"][0][0, -1], tb["steps"][0][0, -1])
        worst = (max(worst[0], rel), min(worst[1], cos))
        agree += sum(x == y for x, y in zip(done_a[i].trace.decode_tokens_out,
                                            done_b[i].trace.decode_tokens_out))
    if not (worst[0] <= DENSE_REL_TOL and worst[1] >= DENSE_MIN_COS):
        fail(f"serve (a) vs (b): first decode step max err / max |logit| {worst[0]}, "
             f"cosine {worst[1]}")
    print(f"serve (a) vs (b): first-token logits bit-identical for all {SERVE_REQUESTS}; first "
          f"decode step, worst request: max abs err / max |logit| {worst[0]:.4f} (tol "
          f"{DENSE_REL_TOL}), cosine {worst[1]:.5f} (min {DENSE_MIN_COS}); greedy tokens "
          f"agreeing {agree} of {steps}")

    # (c) one at a time: drive_serial's results bit for bit
    done_c, sched_c, taps_c, got_c, s_c, _ = serve("(c) c=1", 1)
    record("(c) c=1", got_c)
    for i, (c, (logits, trace)) in enumerate(zip(done_c, refs)):
        if not (np.array_equal(c.result, logits) and np.array_equal(taps_c[i]["first"],
                                                                    ref_taps[i]["first"])
                and c.trace.decode_tokens_out == trace.decode_tokens_out):
            fail(f"serve (c) request {i}: differs from drive_serial")
    if sched_c.real_batch_log:
        fail("serve (c): a batch formed at concurrency 1")
    print(f"serve (c): logits, first-token logits and greedy tokens of all {SERVE_REQUESTS} "
          f"requests bit-identical to drive_serial")

    # (d) preemption with pool swap
    legs = {"out": [], "in": []}
    real = {"out": DeviceTailPool.swap_out, "in": DeviceTailPool.swap_in}

    def leg(name):
        def wrapped(self):
            n = real[name](self)
            legs[name].append(n)
            return n
        return wrapped
    DeviceTailPool.swap_out, DeviceTailPool.swap_in = leg("out"), leg("in")
    try:
        done_d, sched_d, _, got_d, _, _ = serve("(d) c=1 preempt+swap", 1, n=2, preempt=True)
    finally:
        DeviceTailPool.swap_out, DeviceTailPool.swap_in = real["out"], real["in"]
    record("(d) c=1 preempt+swap", got_d)
    victim = done_d[0]
    per_leg = L * pool_bytes
    if not (sched_d.preemptions >= 1 and sched_d.swaps >= 1
            and sum(legs["out"]) == sum(legs["in"]) == sched_d.swaps * per_leg
            and sched_d.swap_bytes == 2 * sched_d.swaps * per_leg):
        fail(f"serve (d): preemptions {sched_d.preemptions}, swaps {sched_d.swaps}, legs out "
             f"{sum(legs['out'])} in {sum(legs['in'])}, swap bytes {sched_d.swap_bytes}, "
             f"expected {per_leg} a leg")
    if not (np.array_equal(victim.result, refs[0][0])
            and victim.trace.decode_tokens_out == refs[0][1].decode_tokens_out):
        fail("serve (d): the preempted request differs from its uninterrupted run")
    print(f"serve (d): {sched_d.preemptions} preemption, {sched_d.swaps} swap of "
          f"{per_leg / 1e6:.2f} MB a leg ({L} layers' pools, both legs counted: "
          f"{sched_d.swap_bytes / 1e6:.2f} MB); the preempted request's logits and greedy tokens "
          f"bit-identical to its uninterrupted run")
    ratio = s_b["mean_tpot"] / s_a["mean_tpot"]
    print(f"serve: (a) against (b): mean TPOT {s_a['mean_tpot'] * 1e3:.3f} vs "
          f"{s_b['mean_tpot'] * 1e3:.3f} ms ((b) / (a) {ratio:.3f}), decode tokens/s "
          f"{s_a['decode_tok_rate']:.2f} vs {s_b['decode_tok_rate']:.2f}, makespan "
          f"{s_a['makespan']:.3f} vs {s_b['makespan']:.3f} s; (c) mean TPOT "
          f"{s_c['mean_tpot'] * 1e3:.3f} ms, makespan {s_c['makespan']:.3f} s ({smi_line})")
    s_e, s_f = _serve_chunked(cfg, serve, record, done_c, taps_c, smi_line)
    hold = _hold_part_b_batch(cfg, engine, suffixes)
    numbers = {k: {m: v[m] for m in ("p50_ttft", "p95_ttft", "mean_tpot", "p95_itl",
                                     "decode_tok_rate", "goodput_rps", "makespan", "mean_batch",
                                     "peak_gib")}
               for k, v in (("a", s_a), ("b", s_b), ("c", s_c), ("e", s_e), ("f", s_f))}
    numbers["part_b_batch_hold"] = hold
    return paths, numbers


def _serve_chunked(cfg, serve, record, done_c, taps_c, smi_line):
    """(e) c = 4 with part B in chunks of SERVE_PREFILL_CHUNK tokens and
    batching on, (f) the same with batching off: (e)'s prefill-chunk
    batches each one launch of chunk_attention's indexed form, the rest of
    part B gathered calls; (e)'s first-token logits within the dense limits
    of (f)'s; (f) bit for bit (c). Returns (e)'s and (f)'s digests."""
    import numpy as np

    L = cfg.n_layers
    done_e, sched_e, taps_e, got_e, s_e, _ = serve("(e) c=4 chunked batched", 4,
                                                   chunk=SERVE_PREFILL_CHUNK)
    done_f, sched_f, taps_f, got_f, s_f, _ = serve("(f) c=4 chunked unbatched", 4, batch=False,
                                                   chunk=SERVE_PREFILL_CHUNK)
    record("(e) c=4 chunked batched", got_e)
    record("(f) c=4 chunked unbatched", got_f)
    pre = [m for m in sched_e.real_batch_log if m[0][1] == "prefill"]
    members = sum(len(m) for m in pre)
    by_form = {k: got_e["chunk_attention"].get(k, 0) for k in ("gathered", "indexed")}
    if any(len(m) < 2 or any(p != "prefill" for _, p, _ in m) for m in pre):
        fail(f"serve (e): prefill-chunk batches {[len(m) for m in pre]}")
    if by_form != {"indexed": len(pre), "gathered": L * SERVE_REQUESTS - members}:
        fail(f"serve (e): chunk_attention launches by form {by_form} for {len(pre)} "
             f"prefill-chunk batches of {members} members")
    if got_f["chunk_attention"].get("indexed", 0) or sched_f.real_batch_log:
        fail("serve (f): a batch formed with batching off")
    if pre:
        print(f"serve (e): {len(pre)} prefill-chunk batches of {[len(m) for m in pre]} members "
              f"(layers' final chunks), chunk_attention launches by form {by_form}")
    else:
        print(f"serve (e): no prefill-chunk batch formed at full width (chunk_attention "
              f"launches by form {by_form}); part_b_batch is held directly below")
    worst = (0.0, 1.0)
    for i in range(SERVE_REQUESTS):
        rel, cos = logit_agreement(taps_e[i]["first"][0, -1], taps_f[i]["first"][0, -1])
        worst = (max(worst[0], rel), min(worst[1], cos))
        c, cf = done_c[i], done_f[i]
        if not (np.array_equal(cf.result, c.result)
                and np.array_equal(taps_f[i]["first"], taps_c[i]["first"])
                and cf.trace.decode_tokens_out == c.trace.decode_tokens_out):
            fail(f"serve (f) request {i}: differs from (c)")
    if not (worst[0] <= DENSE_REL_TOL and worst[1] >= DENSE_MIN_COS):
        fail(f"serve (e) vs (f): first-token logits max err / max |logit| {worst[0]}, cosine "
             f"{worst[1]}")
    print(f"serve (e) vs (f): first-token logits, worst request: max abs err / max |logit| "
          f"{worst[0]:.4g} (tol {DENSE_REL_TOL}), cosine {worst[1]:.6f} (min {DENSE_MIN_COS}); "
          f"(f) bit-identical to (c) in logits, first-token logits and greedy tokens of all "
          f"{SERVE_REQUESTS} requests")
    print(f"serve: (e) against (f): p50 TTFT {s_e['p50_ttft'] * 1e3:.2f} vs "
          f"{s_f['p50_ttft'] * 1e3:.2f} ms, p95 TTFT {s_e['p95_ttft'] * 1e3:.2f} vs "
          f"{s_f['p95_ttft'] * 1e3:.2f} ms, mean TPOT {s_e['mean_tpot'] * 1e3:.3f} vs "
          f"{s_f['mean_tpot'] * 1e3:.3f} ms, makespan {s_e['makespan']:.3f} vs "
          f"{s_f['makespan']:.3f} s ({smi_line})")
    return s_e, s_f


def _hold_part_b_batch(cfg, engine, suffixes, b: int = 4):
    """part_b_batch at full width on b plans' layer-0 final chunks (each plan
    driven up to that op): one launch of the indexed form; each member's A_j
    bit for bit its own single part_b's (the gathered form), h within
    PART_B_BATCH_REL of it; both timed on the host clock to a synchronize."""
    import numpy as np
    import torch

    from repro_torch.core.stepplan import ComputeOp, PrefillChunkCtx, WaitOp, resolve_handle
    from repro_torch.kernels.chunk_attention import ops as ca

    eng = engine(SERVE_PREFILL_CHUNK)
    plans, ctxs, fns = [], [], []
    for i in range(b):
        plan = eng.plan(suffixes[i], request_id=i)
        send = None
        while True:
            op = plan.gen.send(send)
            if isinstance(op, ComputeOp) and isinstance(op.batch_ctx, PrefillChunkCtx):
                break
            if isinstance(op, WaitOp):
                eng.ex.wait(op.handle)
                send = resolve_handle(op.handle)
            else:
                send = eng.ex.compute(op.fn, tag=op.tag)
        plans.append(plan)
        ctxs.append(op.batch_ctx)
        fns.append(op.fn)
    if len({(id(x.backend), x.shape_key()) for x in ctxs}) != 1 or ctxs[0].layer != 0:
        fail("part_b_batch hold: the plans' final chunks do not group")
    before = ca.launches_by_variant["indexed"]
    batched = eng.backend.part_b_batch(ctxs)
    torch.cuda.synchronize()
    if ca.launches_by_variant["indexed"] != before + 1:
        fail("part_b_batch hold: not one launch of the indexed form")
    worst = 0.0
    for i, (fn, (h, mass)) in enumerate(zip(fns, batched)):
        hs, ms = fn()
        if not np.array_equal(mass, ms):
            fail(f"part_b_batch hold: member {i}'s A_j differs from its single part B")
        rel = ((h - hs).abs().max() / hs.abs().max()).item()
        worst = max(worst, rel)
    if not worst <= PART_B_BATCH_REL:
        fail(f"part_b_batch hold: h max err / max |h| {worst} > {PART_B_BATCH_REL}")
    t_batch = wall_ms(lambda: eng.backend.part_b_batch(ctxs))
    t_single = wall_ms(lambda: [fn() for fn in fns])
    for plan in plans:
        plan.gen.close()
    eng.ex.shutdown()
    print(f"serve: part_b_batch held at full width on {b} plans' layer-0 final chunks: one "
          f"launch of the indexed form, each member's A_j bit-identical to its single part B, "
          f"h max abs err / max |h| {worst:.3g} (tol {PART_B_BATCH_REL}); {t_batch:.3f} ms to a "
          f"synchronize against {t_single:.3f} ms for the {b} single part B calls")
    return dict(h_rel_err=worst, batch_wall_ms=t_batch, single_calls_wall_ms=t_single)


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
    widths = (("hymba", hcfg.d_inner), ("falcon-mamba", fcfg.d_inner))
    steps = {}  # the decode step's batched inputs by (width, b)
    for label, d_in in widths:
        for b in (1, 2):
            dec = scan_inputs(b, 1, torch.float32, d_in=d_in)
            h0 = rn(b, d_in, n, dtype=torch.float32)
            e, _, _ = check(f"{label} decode b={b}", dec, h0)
            err = max(err, e)
            steps[label, b] = (dec, h0, e)
    dec = scan_inputs(1, 1, torch.float32)
    h0 = rn(1, hcfg.d_inner, n, dtype=torch.float32)
    fdec = scan_inputs(1, 1, torch.float32, d_in=fcfg.d_inner)
    fh0 = rn(1, fcfg.d_inner, n, dtype=torch.float32)

    def step_bound(a, h_in):  # the decode step: state (and x, dt, B, C, y) moved once
        y, h = selective_scan(*a, h_in)
        b, _, d_in = a[0].shape
        return bounds(nbytes(*a, h_in, y, h), 6.0 * b * d_in * n, b * d_in * n)["tensor_core"]
    r = dict(err=err, ms=device_ms(lambda: selective_scan(*args)), library_ms=None,
             host_ms=host_ms(lambda: selective_scan(*args)),
             plain_ms=wall_ms(lambda: selective_scan_ref(*args), reps=2),
             decode_ms=device_ms(lambda: selective_scan(*dec, h0)),
             decode_host_ms=host_ms(lambda: selective_scan(*dec, h0)),
             decode_bound_ms=step_bound(dec, h0)[0],
             falcon_decode_ms=device_ms(lambda: selective_scan(*fdec, fh0)),
             falcon_decode_host_ms=host_ms(lambda: selective_scan(*fdec, fh0)),
             falcon_decode_bound_ms=step_bound(fdec, fh0)[0],
             bound=scan_bound(args, y_full, h_full))
    print(f"kernels: selective_scan hymba prefill: chunked {r['ms']:.4f} ms on the card, "
          f"plain version {r['plain_ms']:.1f} ms, {bound_text(r['bound'])}, host time per "
          f"call {r['host_ms']:.4f} ms; decode step (sequential) {r['decode_ms']:.4f} ms "
          f"against a bound of {r['decode_bound_ms']:.5f} ms (its state read and written "
          f"once), host time per call {r['decode_host_ms']:.4f} ms; falcon-mamba's decode "
          f"step {r['falcon_decode_ms']:.4f} ms against a bound of "
          f"{r['falcon_decode_bound_ms']:.5f} ms, host time per call "
          f"{r['falcon_decode_host_ms']:.4f} ms; library call: none, no PyTorch call "
          f"computes the scan")
    r["decode_batched"] = {}
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
    # the decode step batched: b = 2, the fleet's state-space batches of two
    # requests, and b = 4 (drawn last, so every input above is as before)
    for label, d_in in widths:
        dec = scan_inputs(4, 1, torch.float32, d_in=d_in)
        h0 = rn(4, d_in, n, dtype=torch.float32)
        e, _, _ = check(f"{label} decode b=4", dec, h0)
        r["err"] = max(r["err"], e)
        steps[label, 4] = (dec, h0, e)
    for (label, b), (a, h_in, e) in steps.items():
        if b == 1:
            continue
        bound = step_bound(a, h_in)
        row = dict(max_abs_err=e, ms=device_ms(lambda: selective_scan(*a, h_in)),
                   bound_ms=bound[0], bound_by=bound[1],
                   host_ms=host_ms(lambda: selective_scan(*a, h_in)),
                   plain_ms=wall_ms(lambda: selective_scan_ref(*a, h_in), reps=3))
        r["decode_batched"].setdefault(label, {})[str(b)] = row
        print(f"kernels: selective_scan {label} decode step b={b} (sequential): "
              f"{row['ms']:.4f} ms on the card against a bound of {bound[0]:.5f} ms by "
              f"{bound[2]} (b states read and written once), plain version "
              f"{row['plain_ms']:.3f} ms, host time per call {row['host_ms']:.4f} ms")
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
    traces = []
    reset_counts(*ops.values())
    for i, suffix in enumerate(suffixes):
        before = {k: mod.launches for k, mod in ops.items()}
        busy = dict(ex.stage_times)
        t0 = time.perf_counter()
        logits, trace = eng.reprefill(suffix, request_id=i, decode_tokens=DECODE_TOKENS)
        walls.append((time.perf_counter() - t0) * 1e3)
        traces.append(trace)
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
    # (one per decode_attention call; part B's attention pass and merge;
    # chunk_score's split pass and merge)
    before = {k: mod.launches for k, mod in ops.items()}
    ours = profile_request(eng, suffixes[0], statistics.mean(walls[1:]))
    got = {k: mod.launches - before[k] for k, mod in ops.items()}
    per_call = hold_device_kernels("e2e", ours, got, expect)

    # budget 1.0 against the dense forward over prefix + suffix
    full = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                              budget=1.0,
                              period=PERIOD, subperiod=SUBPERIOD)
    logits, _ = full.reprefill(suffixes[0])
    toks = torch.as_tensor(np.concatenate([prefix, suffixes[0]]), device=DEVICE)[None]
    dense = T.forward(params, {"tokens": toks}, cfg, logits_positions="last")[0, -1]
    hold_to_dense("e2e: budget 1.0", logits, dense)
    ex.shutdown()
    # what the baselines phase shares: the weights, the prefix and its dense
    # session, the suffixes, the dense forward over prefix + suffixes[0] and
    # ContiguousKV's requests on each suffix
    ctx = dict(params=params, prefix=prefix, sess=sess, suffixes=suffixes, dense=dense,
               ckv_traces=traces, ckv_walls=walls)
    return totals, per_call, ctx


def phase_baselines(cfg, ctx):
    """The paper's baselines on the dense phase's weights, prefix and
    suffixes: ingest a coarse-block session; serve N_BASELINE_REQUESTS
    requests through AS-LRU, AS-H2O-LFU and IMPRESS each (budget 0.25 where
    the engine takes one, caps 0), with launches per request, read
    amplification and tokens loaded asserted; ContiguousKV w/o P held to the
    full engine bit for bit; AS-LRU and budget-1.0 AS-H2O held to the dense
    forward; one IMPRESS request profiled. Returns ({kernel: {path:
    launches}}, {wrapper: {device kernel: per call}} of the profiled IMPRESS
    request)."""
    import numpy as np

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import (ASH2OEngine, ASLRUEngine, ContiguousKVEngine,
                                         IMPRESSEngine)
    from repro_torch.core.session import build_real_session
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.storage.timing import RealExecutor

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da}
    params, prefix, suffixes = ctx["params"], ctx["prefix"], ctx["suffixes"]
    L = cfg.n_layers
    be = RealCompute(cfg, params, device=DEVICE)
    reset_counts(fa)
    t0 = time.perf_counter()
    csess = build_real_session(cfg, params, prefix, coarse_blocks=True, block_tokens=BLOCK,
                               in_memory=True, device=DEVICE)
    ingest_s = time.perf_counter() - t0
    totals = {"flash_attention": {"coarse-block ingest": counts(fa)}}
    if totals["flash_attention"]["coarse-block ingest"] != {"launches": L, "wgmma": L}:
        fail(f"baselines: coarse ingest flash_attention launches {counts(fa)}, expected {L}")
    layout = csess.store.layout
    print(f"baselines: coarse-block ingest of {PREFIX_LEN} tokens ({layout.n_units} blocks of "
          f"{BLOCK}) took {ingest_s:.2f} s (flash_attention launches {counts(fa)})")

    ex = RealExecutor()
    engines = {"as_lru": ASLRUEngine(csess, be, ex),
               "as_h2o_lfu": ASH2OEngine(csess, be, ex, budget=BUDGET),
               "impress": IMPRESSEngine(csess, be, ex, budget=BUDGET)}
    summary = {}
    for name, eng in engines.items():
        expect = {"chunk_score": 0 if name == "as_lru" else L, "chunk_attention": L,
                  "decode_attention": L * DECODE_TOKENS}
        reset_counts(*ops.values())
        rows = []
        for i, suffix in enumerate(suffixes[:N_BASELINE_REQUESTS]):
            before = {k: mod.launches for k, mod in ops.items()}
            busy = dict(ex.stage_times)
            t0 = time.perf_counter()
            logits, trace = eng.reprefill(suffix, request_id=i, decode_tokens=DECODE_TOKENS)
            wall = (time.perf_counter() - t0) * 1e3
            got = {k: mod.launches - before[k] for k, mod in ops.items()}
            if got != expect:
                fail(f"{name} request {i}: kernel launches {got}, expected {expect}")
            ra = trace.read_amplification
            if name == "as_lru":
                if ra != 1.0:
                    fail(f"as_lru request {i}: read amplification {ra}, expected 1.0")
            else:
                # sum |blocks_l| B / sum |tokens_l|, from the selections alone
                sel = list(trace.selected_per_layer.values())
                if len(sel) != L:
                    fail(f"{name} request {i}: selections for {len(sel)} of {L} layers")
                blocks = [layout.units_for_tokens(t) for t in sel]
                want = sum(map(len, blocks)) * BLOCK / sum(map(len, sel))
                partial = any(np.any(np.bincount(t // BLOCK, minlength=layout.n_units)[b] < BLOCK)
                              for t, b in zip(sel, blocks))
                if ra != want or (want > 1.0) != partial:
                    fail(f"{name} request {i}: read amplification {ra}, recomputed {want}, "
                         f"a partly selected block: {partial}")
            ckv_loaded = ctx["ckv_traces"][i].tokens_loaded
            if not trace.tokens_loaded > ckv_loaded:
                fail(f"{name} request {i}: {trace.tokens_loaded} tokens loaded, not more than "
                     f"ContiguousKV's {ckv_loaded} on the same suffix")
            toks = trace.decode_tokens_out
            if (logits.shape != (1, 1, cfg.vocab_size) or not np.isfinite(logits).all()
                    or len(toks) != DECODE_TOKENS
                    or not all(0 <= t < cfg.vocab_size for t in toks)):
                fail(f"{name} request {i}: bad output {logits.shape} {toks}")
            # host clock inside the compute ops by tag (identify among them)
            # and the waits on IO (probe_io, kv_io)
            busy = {k: round((v - busy.get(k, 0.0)) * 1e3, 2) for k, v in ex.stage_times.items()}
            stages = {k: round(v * 1e3, 2) for k, v in trace.stages.items()}
            rows.append(dict(ttft=trace.ttft * 1e3, tpot=trace.tpot * 1e3, wall=wall))
            print(f"baselines: {name} request {i}: TTFT {trace.ttft * 1e3:.2f} ms, TPOT "
                  f"{trace.tpot * 1e3:.3f} ms, compute ops ms {busy}, waits ms {stages}, "
                  f"tokens loaded "
                  f"{trace.tokens_loaded} (ContiguousKV {ckv_loaded}), read amplification "
                  f"{ra:.4f}, launches {got}")
        for k, mod in ops.items():
            if mod.launches:
                totals.setdefault(k, {})[f"{name} requests"] = counts(mod)
        warm = rows[1:]
        summary[name] = {k: statistics.mean(r[k] for r in warm) for k in ("ttft", "tpot", "wall")}
        print(f"baselines: {name}: warm requests' mean TTFT {summary[name]['ttft']:.2f} ms, "
              f"TPOT {summary[name]['tpot']:.3f} ms")

    # w/o P on the dense session: the same selections and first-token logits
    ckv = {p: ContiguousKVEngine(ctx["sess"], be, ex, budget=BUDGET, period=PERIOD,
                                 subperiod=SUBPERIOD, prefetch=p) for p in (True, False)}
    reset_counts(*ops.values())
    (l_full, t_full), (l_wo, t_wo) = (ckv[p].reprefill(suffixes[0]) for p in (True, False))
    for k, mod in ops.items():
        if mod.launches:
            totals.setdefault(k, {})["contiguous_kv and w/o P first tokens"] = counts(mod)
    same_sel = all(np.array_equal(t_wo.selected_per_layer[l], sel)
                   for l, sel in t_full.selected_per_layer.items())
    if not (same_sel and np.array_equal(l_wo, l_full) and t_wo.ssd_bytes_spec == 0):
        fail(f"w/o P: selections equal {same_sel}, logits equal "
             f"{np.array_equal(l_wo, l_full)}, speculative bytes {t_wo.ssd_bytes_spec}")
    print(f"baselines: ContiguousKV w/o P: selections and first-token logits bit-identical to "
          f"the full engine's; speculative bytes {t_wo.ssd_bytes_spec} (full engine "
          f"{t_full.ssd_bytes_spec}); TTFT {t_wo.ttft * 1e3:.2f} ms (full engine "
          f"{t_full.ttft * 1e3:.2f} ms)")

    # against the dense forward: AS-LRU (every block, c = 64) and AS-H2O at
    # budget 1.0 (every token, c = 1)
    reset_counts(*ops.values())
    logits, _ = engines["as_lru"].reprefill(suffixes[0])
    hold_to_dense("baselines: as_lru", logits, ctx["dense"])
    logits, _ = ASH2OEngine(csess, be, ex, budget=1.0).reprefill(suffixes[0])
    hold_to_dense("baselines: as_h2o_lfu budget 1.0", logits, ctx["dense"])
    for k, mod in ops.items():
        if mod.launches:
            totals.setdefault(k, {})["dense checks (as_lru, as_h2o_lfu budget 1.0)"] = counts(mod)

    # one IMPRESS request profiled
    before = {k: mod.launches for k, mod in ops.items()}
    ours = profile_request(engines["impress"], suffixes[0], summary["impress"]["wall"],
                           tag="baselines: impress")
    got = {k: mod.launches - before[k] for k, mod in ops.items()}
    per_call = hold_device_kernels(
        "baselines: impress", ours, got,
        {"chunk_score": L, "chunk_attention": L, "decode_attention": L * DECODE_TOKENS})

    ckv_ttft = statistics.mean(t.ttft * 1e3 for t in ctx["ckv_traces"][1:N_BASELINE_REQUESTS])
    print(f"baselines: warm TTFT on this card's in-memory store (compute and host work only, "
          f"not the paper's SSD-bound regime; a record, no claim): ContiguousKV "
          f"{ckv_ttft:.2f} ms, IMPRESS {summary['impress']['ttft']:.2f} ms "
          f"(IMPRESS / ContiguousKV {summary['impress']['ttft'] / ckv_ttft:.3f}), AS-LRU "
          f"{summary['as_lru']['ttft']:.2f} ms (AS-LRU / ContiguousKV "
          f"{summary['as_lru']['ttft'] / ckv_ttft:.3f}), AS-H2O-LFU "
          f"{summary['as_h2o_lfu']['ttft']:.2f} ms")
    ex.shutdown()
    return totals, per_call


def hold_device_kernels(tag, ours, got, expect) -> dict:
    """Hold a profiled request's device kernels to its wrappers' launches:
    one decode kernel per decode_attention call, part B's attention pass and
    merge per chunk_attention call, chunk_score's split pass and merge per
    chunk_score call. Returns {wrapper: {device kernel: launches per call}}."""
    kernels_of = {"chunk_attention": ("chunk_attn_kernel", "chunk_merge_kernel"),
                  "decode_attention": ("decode_kernel",),
                  "chunk_score": ("chunk_score_kernel", "chunk_score_merge_kernel")}
    want = {kn: got[w] for w, names in kernels_of.items() for kn in names}
    seen = {k: ours.get(k, (0, 0.0))[0] for k in want}
    if got != expect or seen != want:
        fail(f"{tag}: profiled request: wrapper launches {got} (expected {expect}), device "
             f"kernels {seen} (expected {want})")
    per_call = {w: {kn: seen[kn] / got[w] for kn in names}
                for w, names in kernels_of.items() if got[w]}
    print(f"{tag}: profiled request: device kernels per wrapper call {per_call}")
    return per_call


def hold_to_dense(tag, logits, dense):
    """First-token logits (numpy, (1, 1, vocab)) against the dense forward's
    last logits (a card tensor), to DENSE_REL_TOL / DENSE_MIN_COS."""
    import torch

    a = torch.as_tensor(logits[0, -1], device=dense.device)
    rel = ((a - dense).abs().max() / dense.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(a, dense, dim=0).item()
    print(f"{tag} vs dense forward: max abs err / max |logit| {rel:.4f} "
          f"(tol {DENSE_REL_TOL}), cosine {cos:.5f} (min {DENSE_MIN_COS}), argmax "
          f"{int(a.argmax())} vs {int(dense.argmax())}")
    if not (rel <= DENSE_REL_TOL and cos >= DENSE_MIN_COS):
        fail(f"{tag}: first-token logits disagree with the dense forward")


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
    tokens. Returns ({kernel: launches} over the requests, the weights)."""
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
    held_gib = torch.cuda.memory_allocated() / 2 ** 30  # earlier phases' weights
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
    outputs = []
    for i, suffix in enumerate(suffixes):
        reset_counts(*ops.values())
        busy = dict(ex.stage_times)
        t0 = time.perf_counter()
        logits, trace = eng.reprefill(suffix, request_id=i, decode_tokens=DECODE_TOKENS)
        walls.append((time.perf_counter() - t0) * 1e3)
        outputs.append((logits, trace.decode_tokens_out))
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
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({held_gib:.1f} GiB of other "
          f"models' weights held when the phase began)")
    warm = walls[1:] if len(walls) > 1 else walls
    # the profiled request: the scan's device kernels, held to the wrapper's
    # launches per variant (the step kernel per sequential launch; the pack
    # and scan kernels per chunked one)
    reset_counts(ss)
    ours = profile_request(eng, suffixes[0], statistics.mean(warm), tag=f"state: {cfg.name}")
    by_variant = dict(ss.launches_by_variant)
    want = {"selective_scan_step_kernel": by_variant["sequential"],
            "selective_scan_pack_kernel": by_variant["chunked"],
            "selective_scan_chunked_kernel": by_variant["chunked"]}
    seen = {k: ours.get(k, (0, 0.0))[0] for k in want}
    if seen != want or by_variant != {"sequential": L * DECODE_TOKENS, "chunked": L}:
        fail(f"{cfg.name} profiled request: scan launches {by_variant}, device kernels "
             f"{seen} (expected {want})")
    print(f"state: {cfg.name} profiled request: device kernels {seen}, the scan wrapper's "
          f"launches {by_variant}: one step kernel per decode step")

    if check_decode:
        # the prefill in ops of STATE_PREFILL_CHUNK tokens: only the last runs
        # it, so the request equals the unchunked one bit for bit
        chunked = StateSpaceEngine(cfg, be, ex, prefix_tokens=prefix,
                                   prefill_chunk_tokens=STATE_PREFILL_CHUNK)
        reset_counts(*ops.values())
        plan = chunked.plan(suffixes[0], request_id=0, decode_tokens=DECODE_TOKENS)
        n_pre, send = 0, None
        try:  # drive_serial, counting the prefill ops (the plan has no waits)
            while True:
                op = plan.gen.send(send)
                n_pre += op.phase == "prefill"
                send = ex.compute(op.fn, flops=op.flops, hbm_bytes=op.hbm_bytes, tag=op.tag)
                plan.clock.t = ex.now()
        except StopIteration as stop:
            logits = stop.value
        got = {k: counts(mod) for k, mod in ops.items()}
        want_ops = -(-(PREFIX_LEN + SUFFIX_LEN) // STATE_PREFILL_CHUNK)
        if not (np.array_equal(logits, outputs[0][0]) and got == expect
                and plan.trace.decode_tokens_out == outputs[0][1] and n_pre == want_ops):
            fail(f"{cfg.name}: the prefill in chunks of {STATE_PREFILL_CHUNK} differs from the "
                 f"unchunked request (launches {got}, prefill ops {n_pre} of {want_ops})")
        print(f"state: {cfg.name} request 0 with its prefill in {n_pre} ops of up to "
              f"{STATE_PREFILL_CHUNK} tokens: logits and greedy tokens bit-identical to the "
              f"unchunked request, launches {got}")
        prompt = np.concatenate([prefix, suffixes[0]])
        decode_vs_prefill(be, prompt, STEP_BF16_REL_TOL, STEP_BF16_MIN_COS)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = _tree_map(params, lambda t: t.to(torch.float32))
        decode_vs_prefill(StateCompute(cfg32, params32, device=DEVICE), prompt,
                          STEP_REL_TOL, STEP_MIN_COS)
        del params32
    ex.shutdown()
    return totals, params


def phase_fleet(cfgs, params, smi_line):
    """The heterogeneous fleet on the earlier phases' full-width weights
    (``cfgs`` and ``params`` by model name), as serve --fleet builds it: one
    engine and backend per tenant of FLEET_SPEC, tenant-namespaced sessions of
    one dense ingest, every prompt below the fleet's smallest vocab. (g) c = 1
    against each engine's drive_serial alone, (h) c = 8 batched, (i)
    preemption with swap of a falcon-mamba and a hymba decode, held as the
    module docstring says. Returns ({kernel: {path: launches}}, numbers)."""
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da,
           "flash_attention": fa, "selective_scan": ss}
    with plain_versions_counted(ops) as plain_calls:
        return _fleet_runs(cfgs, params, smi_line, ops, plain_calls)


def _fleet_runs(cfgs, params, smi_line, ops, plain_calls):
    import numpy as np
    import torch

    from repro_torch.core.backends import RealCompute, StateCompute, StatePool, _stack_states
    from repro_torch.core.engine import ContiguousKVEngine, StateSpaceEngine
    from repro_torch.core.session import build_real_session
    from repro_torch.models.transformer import STATE_FAMILIES
    from repro_torch.serving import Request, Scheduler, parse_fleet_spec, summarize
    from repro_torch.storage.h2d_meter import H2DMeter
    from repro_torch.storage.timing import RealExecutor

    ss = ops["selective_scan"]
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    roster = [name for name, n in parse_fleet_spec(FLEET_SPEC) for _ in range(n)]
    tenants = list(range(1, len(roster) + 1))
    tcfg = {t: cfgs[name] for t, name in zip(tenants, roster)}
    # the full-width vocabs differ (152064, 32001, 65024): every tenant reads
    # the same prompts, so they are drawn below the smallest
    vocab = min(c.vocab_size for c in tcfg.values())
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, vocab, PREFIX_LEN)
    suffixes = [rng.integers(0, vocab, SUFFIX_LEN) for _ in range(FLEET_REQUESTS)]
    dcfg = next(c for c in tcfg.values() if c.family not in STATE_FAMILIES)
    reset_counts(*ops.values())
    t0 = time.perf_counter()
    sess = build_real_session(dcfg, params[dcfg.name], prefix, chunk_tokens=CHUNK,
                              in_memory=True, device=DEVICE)
    ingest = counts(ops["flash_attention"])
    if ingest != {"launches": dcfg.n_layers, "wgmma": dcfg.n_layers}:
        fail(f"fleet ingest: flash_attention launches {ingest}, expected {dcfg.n_layers}")
    paths = {"flash_attention": {"fleet ingest": ingest}}
    print(f"fleet: {FLEET_SPEC}: tenants "
          + ", ".join(f"t{t}={c.name}[{c.family}, vocab {c.vocab_size}]"
                      for t, c in tcfg.items())
          + f"; prompts drawn below vocab {vocab}; ingest of the {PREFIX_LEN}-token prefix "
          f"for the dense tenants {time.perf_counter() - t0:.2f} s (flash_attention "
          f"launches {ingest})")

    def engine(t, ex):
        """Tenant t's engine over a backend of its own, as serve --fleet
        builds them."""
        c = tcfg[t]
        if c.family in STATE_FAMILIES:
            return StateSpaceEngine(c, StateCompute(c, params[c.name], device=DEVICE), ex,
                                    prefix_tokens=prefix, tenant=t)
        return ContiguousKVEngine(dataclasses.replace(sess, tenant=t),
                                  RealCompute(c, params[c.name], device=DEVICE), ex,
                                  budget=BUDGET, period=PERIOD, subperiod=SUBPERIOD)

    def engines(ex):
        return {t: engine(t, ex) for t in tenants}

    def tenant_of(rid):
        return 1 + rid % len(tenants)

    def requests(n, **kw):
        return [Request(request_id=r, suffix=suffixes[r], tenant=tenant_of(r),
                        decode_tokens=FLEET_DECODE, **kw) for r in range(n)]

    def record(label, got):
        for k, c in got.items():
            if c["launches"]:
                paths.setdefault(k, {})[f"fleet {label}"] = c

    def check_done(label, done, n):
        if [c.request.request_id for c in done] != list(range(n)):
            fail(f"fleet {label}: {len(done)} of {n} requests completed")
        for c in done:
            V = tcfg[c.request.tenant].vocab_size
            toks = c.trace.decode_tokens_out
            if (c.result.shape != (1, 1, V) or not np.isfinite(c.result).all()
                    or len(toks) != FLEET_DECODE or not all(0 <= t < V for t in toks)):
                fail(f"fleet {label} request {c.request.request_id}: bad output")
        if plain_calls:
            fail(f"fleet {label}: plain versions ran on the card: {plain_calls}")

    # (g) c = 1: each tenant's request bit for bit its engine's drive_serial
    # run alone
    ex = RealExecutor()
    eng_g = engines(ex)
    taps_g = {t: _tapped(e) for t, e in eng_g.items()}
    n_g = len(tenants)
    alone = {}
    for r in range(n_g):
        logits, trace = eng_g[tenant_of(r)].reprefill(suffixes[r], request_id=r,
                                                      decode_tokens=FLEET_DECODE)
        alone[r] = (logits, trace.decode_tokens_out, taps_g[tenant_of(r)].pop(r))
    reset_counts(*ops.values())
    plain_calls.clear()
    sched = Scheduler(eng_g, max_concurrency=1)
    done_g = sched.run(requests(n_g))
    torch.cuda.synchronize()
    got = {k: counts(mod) for k, mod in ops.items()}
    record("(g) c=1", got)
    check_done("(g) c=1", done_g, n_g)
    if sched.real_batch_log:
        fail("fleet (g): a batch formed at concurrency 1")
    for c in done_g:
        r, t = c.request.request_id, c.request.tenant
        logits, toks, tap = alone[r]
        if not (np.array_equal(c.result, logits) and c.trace.decode_tokens_out == toks
                and np.array_equal(taps_g[t][r]["first"], tap["first"])):
            fail(f"fleet (g) request {r} ({tcfg[t].name}): differs from its engine alone")
    print(f"fleet (g) c=1: {n_g} requests, one a tenant: first-token logits, last logits and "
          f"greedy tokens bit-identical to each engine's drive_serial run alone; launches "
          f"{got}")

    # (h) c = 8 batched: per-tenant scan launches around every decode call of
    # the state backends (a batched step counted once), and each batched
    # state-space step's members
    ex = RealExecutor()
    eng_h = engines(ex)
    taps_h = {t: _tapped(e) for t, e in eng_h.items()}
    seq_by_tenant = dict.fromkeys(tenants, 0)
    batched_steps = []  # (tenant, [(pool, pos, logits)])
    depth = [0]
    for t, e in eng_h.items():
        if not isinstance(e.backend, StateCompute):
            continue
        be = e.backend
        for name in ("decode_step", "decode_step_batch"):
            def metered(arg, *a, _f=getattr(be, name), _t=t, _batch=name.endswith("batch")):
                outer = depth[0] == 0
                depth[0] += 1
                n0 = ss.launches_by_variant["sequential"]
                try:
                    out = _f(arg, *a)
                finally:
                    depth[0] -= 1
                if outer:
                    seq_by_tenant[_t] += ss.launches_by_variant["sequential"] - n0
                if _batch:
                    batched_steps.append((_t, [(c.pools[0], c.pos, lg)
                                               for c, lg in zip(arg, out)]))
                return out
            setattr(be, name, metered)
    reset_counts(*ops.values())
    plain_calls.clear()
    sched = Scheduler(eng_h, policy="fcfs", max_concurrency=FLEET_REQUESTS)
    t0 = time.perf_counter()
    done_h = sched.run(requests(FLEET_REQUESTS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stage_ms = {k: round(v * 1e3, 1) for k, v in ex.stage_times.items()}
    ex.shutdown()
    got = {k: counts(mod) for k, mod in ops.items()}
    record("(h) c=8 batched", got)
    check_done("(h) c=8 batched", done_h, FLEET_REQUESTS)
    log = sched.real_batch_log
    for m in log:
        if len({wk for _, _, wk in m}) != 1:
            fail(f"fleet (h): a batch spans weight streams: {m}")
    by_stream = {}
    for m in log:
        by_stream.setdefault(m[0][2], []).append(len(m))
    state_keys = {f"model@{c.name}" for c in tcfg.values() if c.family in STATE_FAMILIES}
    if not any(n >= 2 for k in state_keys for n in by_stream.get(k, [])):
        fail(f"fleet (h): no state-space decode batch of two or more: {by_stream}")
    # the scan's step kernel: one launch per layer per decode execution, a
    # batched step once for all its members
    for t, c in tcfg.items():
        if c.family not in STATE_FAMILIES:
            continue
        rids = [r for r in range(FLEET_REQUESTS) if tenant_of(r) == t]
        shared = sum(len(m) - 1 for m in log if m[0][0] in rids and m[0][1] == "decode")
        want = c.n_layers * (len(rids) * FLEET_DECODE - shared)
        if seq_by_tenant[t] != want:
            fail(f"fleet (h) tenant {t} ({c.name}): selective_scan sequential launches "
                 f"{seq_by_tenant[t]}, expected {want}")
    if sum(seq_by_tenant.values()) != got["selective_scan"].get("sequential", 0):
        fail(f"fleet (h): sequential launches {got['selective_scan']} against the tenants' "
             f"{seq_by_tenant}")
    # a batched step's logits against (g)'s unbatched ones for the same suffix
    # and step (the first decode step, fed the same token)
    total = PREFIX_LEN + SUFFIX_LEN
    held, worst = 0, (0.0, 1.0)
    for t, members in batched_steps:
        for pool, pos, lg in members:
            r = next(r for r, tap in taps_h[t].items() if tap.get("pool") is pool)
            if pos != total or r >= n_g:
                continue
            rel, cos = logit_agreement(lg[0, -1], taps_g[t][r]["steps"][0][0, -1])
            worst = (max(worst[0], rel), min(worst[1], cos))
            held += 1
    if not held or not (worst[0] <= STEP_BF16_REL_TOL and worst[1] >= STEP_BF16_MIN_COS):
        fail(f"fleet (h): {held} batched first decode steps held against (g), worst max "
             f"err / max |logit| {worst[0]}, cosine {worst[1]}")
    # what the batched step adds per member: the stack of the members' states
    # and the copy of each member's slice back into its own tensors, on two
    # finished pools of each state-space tenant
    stack_ms = {}
    for t, c in tcfg.items():
        if c.family not in STATE_FAMILIES:
            continue
        states = [tap["pool"].state for tap in taps_h[t].values()][:2]
        stacked = _stack_states(states)

        def copy_back():
            for i, st in enumerate(states):
                for key, v in stacked.items():
                    if key != "length":
                        st[key].copy_(v[:, i: i + 1])
        moved = 2 * sum(v.numel() * v.element_size() for v in stacked.values()
                        if isinstance(v, torch.Tensor))  # each of the two: read, written
        stack_ms[c.name] = dict(stack_ms=device_ms(lambda: _stack_states(states), reps=10),
                                copy_back_ms=device_ms(copy_back, reps=10),
                                bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        del stacked
        print(f"fleet (h) {c.name}: a batched step of two stacks the members' states in "
              f"{stack_ms[c.name]['stack_ms']:.4f} ms and copies them back in "
              f"{stack_ms[c.name]['copy_back_ms']:.4f} ms ({moved / 2 / 1e6:.1f} MB read and "
              f"written by each: a bound of {stack_ms[c.name]['bound_ms']:.4f} ms each)")
    s_h = summarize(done_h)
    print(f"fleet (h) c={FLEET_REQUESTS} batched: {FLEET_REQUESTS} requests (tenant 1 + rid % "
          f"{len(tenants)}), p50 TTFT {s_h['p50_ttft'] * 1e3:.2f} ms, p95 TTFT "
          f"{s_h['p95_ttft'] * 1e3:.2f} ms, mean TPOT {s_h['mean_tpot'] * 1e3:.3f} ms, p95 ITL "
          f"{s_h['p95_itl'] * 1e3:.3f} ms, {s_h['decode_tok_rate']:.2f} decode tokens/s, "
          f"makespan {s_h['makespan']:.3f} s, wall {wall:.3f} s of which compute ops ms by tag "
          f"{stage_ms}; launches {got} ({smi_line})")
    for t, c in tcfg.items():
        mine = [d for d in done_h if d.request.tenant == t]
        print(f"fleet (h) tenant {t} {c.name}: TTFT "
              + ", ".join(f"{d.ttft * 1e3:.2f}" for d in mine) + " ms, TPOT "
              + ", ".join(f"{d.trace.tpot * 1e3:.3f}" for d in mine) + " ms"
              + (f", selective_scan sequential launches {seq_by_tenant[t]}"
                 if c.family in STATE_FAMILIES else ""))
    print(f"fleet (h): batches by weight stream (sizes): {by_stream}; {held} batched first "
          f"decode steps against (g)'s unbatched: worst max abs err / max |logit| "
          f"{worst[0]:.4f} (tol {STEP_BF16_REL_TOL}), cosine {worst[1]:.5f} (min "
          f"{STEP_BF16_MIN_COS}); every batch one weight stream")

    # (i) preemption with swap of a falcon-mamba and a hymba decode: the
    # victim's greedy tokens bit for bit its uninterrupted (g) run, each leg
    # StatePool.nbytes, the meter seeing the swap-in and no pool-sized copy
    # in the decode steps
    legs = []  # (leg, bytes, ms, metered bytes)
    real = {"out": StatePool.swap_out, "in": StatePool.swap_in}

    def leg(name):
        def wrapped(pool):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with H2DMeter(DEVICE) as m:
                n = real[name](pool)
            torch.cuda.synchronize()
            legs.append((name, n, (time.perf_counter() - t0) * 1e3, m.total, pool.nbytes))
            return n
        return wrapped
    swaps = {}
    StatePool.swap_out, StatePool.swap_in = leg("out"), leg("in")
    try:
        for t, c in tcfg.items():
            if c.family not in STATE_FAMILIES:
                continue
            r = t - 1  # (g)'s request of this tenant
            eng = engine(t, RealExecutor())
            transfers = []
            be = eng.backend

            def metered_step(*a, _f=be.decode_step):
                with H2DMeter(DEVICE) as m:
                    out = _f(*a)
                transfers.extend(n for _, n in m.transfers)
                return out
            be.decode_step = metered_step
            del legs[:]
            reset_counts(*ops.values())
            plain_calls.clear()
            sched = Scheduler(eng, max_concurrency=1, preempt=True, swap_on_preempt=True,
                              prefill_estimate=1e3)
            done = sched.run([
                Request(request_id=0, suffix=suffixes[r], tenant=t, decode_tokens=FLEET_DECODE),
                Request(request_id=1, suffix=suffixes[n_g + r], tenant=t, decode_tokens=1,
                        ttft_target=SERVE_TTFT_TARGET)])
            eng.ex.shutdown()
            got = {k: counts(mod) for k, mod in ops.items()}
            record(f"(i) {c.name} preempt+swap", got)
            if plain_calls:
                fail(f"fleet (i) {c.name}: plain versions ran on the card: {plain_calls}")
            L, d_in, n = c.n_layers, c.d_inner, c.ssm_state
            want = L * (d_in * n * 4 + (c.ssm_conv - 1) * d_in * 2)  # ssm_h, ssm_conv
            if c.has_attention:  # hybrid: the preallocated KV buffers
                want += 2 * L * (total + FLEET_DECODE + 1) * c.n_kv_heads * c.d_head * 2
            victim = done[0]
            outs, ins = [x for x in legs if x[0] == "out"], [x for x in legs if x[0] == "in"]
            if not (sched.preemptions >= 1 and sched.swaps >= 1 and len(outs) == len(ins)
                    == sched.swaps and all(x[1] == x[4] == want for x in legs)
                    and all(x[3] == want for x in ins) and sched.swap_bytes == 2 * sum(
                        x[1] for x in outs)):
                fail(f"fleet (i) {c.name}: preemptions {sched.preemptions}, swaps "
                     f"{sched.swaps}, legs {legs}, swap bytes {sched.swap_bytes}, expected "
                     f"{want} a leg")
            if not transfers or max(transfers) >= want // L:
                fail(f"fleet (i) {c.name}: a decode-step host-to-device copy of "
                     f"{max(transfers, default=0)} B, not below one layer's state")
            if not (victim.trace.decode_tokens_out == alone[r][1]
                    and np.array_equal(victim.result, alone[r][0])):
                fail(f"fleet (i) {c.name}: the preempted request differs from its "
                     f"uninterrupted run")
            swaps[c.name] = dict(bytes_per_leg=want, swaps=sched.swaps,
                                 out_ms=[x[2] for x in outs], in_ms=[x[2] for x in ins])
            print(f"fleet (i) {c.name}: {sched.preemptions} preemption, {sched.swaps} swap of "
                  f"{want / 1e6:.2f} MB a leg (StatePool.nbytes; both legs counted: "
                  f"{sched.swap_bytes / 1e6:.2f} MB), swap-out "
                  + ", ".join(f"{x[2]:.2f}" for x in outs) + " ms, swap-in "
                  + ", ".join(f"{x[2]:.2f}" for x in ins) + f" ms; the meter saw the swap-in "
                  f"({ins[0][3]} B) and {len(transfers)} decode-step copies of at most "
                  f"{max(transfers)} B; logits and greedy tokens bit-identical to the uninterrupted "
                  f"run")
    finally:
        StatePool.swap_out, StatePool.swap_in = real["out"], real["in"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"fleet: peak device memory {peak:.2f} GiB ({base_gib:.2f} GiB held when the phase "
          f"began: the three models' weights and the dense phases' sessions)")
    numbers = {m: s_h[m] for m in ("p50_ttft", "p95_ttft", "mean_tpot", "p95_itl",
                                   "decode_tok_rate", "makespan")}
    numbers.update(batches=by_stream, swaps=swaps, stack=stack_ms, peak_gib=peak)
    return paths, numbers


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
    smi_line = phase_device()
    # the dense phases first, so their requests run in the same process
    # state as before the state-space phases existed
    rows = phase_kernels(cfg)
    rows["decode_attention"]["pools_form"] = phase_pools_kernels(cfg)
    rows["chunk_attention"]["indexed"] = phase_indexed_kernels(cfg)
    for name, shapes in phase_baseline_kernels(cfg).items():
        rows[name]["baseline_shapes"] = shapes
    paths, per_call, ctx = phase_e2e(cfg)
    for name, k in per_call.items():
        rows[name]["device_kernels_per_call"] = k
    base_paths, base_per_call = phase_baselines(cfg, ctx)
    for name, by_path in base_paths.items():
        paths.setdefault(name, {}).update(by_path)
    for name, k in base_per_call.items():
        rows[name]["device_kernels_per_call_impress"] = k
    serve_paths, serve_numbers = phase_serve(cfg, ctx, smi_line)
    for name, by_path in serve_paths.items():
        paths.setdefault(name, {}).update(by_path)
    rows["decode_attention"]["serve"] = {k: serve_numbers[k] for k in "abc"}
    rows["chunk_attention"]["serve"] = {k: serve_numbers[k]
                                        for k in ("e", "f", "part_b_batch_hold")}
    # the Qwen weights stay for the fleet phase, the other sessions go
    weights = {cfg.name: ctx["params"]}
    del ctx
    torch.cuda.empty_cache()
    rows.update(phase_state_kernels(hcfg, cfg, fcfg))
    totals, weights[hcfg.name] = phase_state_e2e(hcfg, N_REQUESTS, check_decode=True)
    for name, n in totals.items():
        paths.setdefault(name, {})["hymba-1.5b requests"] = n
    torch.cuda.empty_cache()
    totals, weights[fcfg.name] = phase_state_e2e(fcfg, 1, check_decode=False)
    for name, n in totals.items():
        if n["launches"]:
            paths.setdefault(name, {})["falcon-mamba-7b request"] = n
    fleet_paths, fleet_numbers = phase_fleet({c.name: c for c in (cfg, hcfg, fcfg)}, weights,
                                             smi_line)
    for name, by_path in fleet_paths.items():
        paths.setdefault(name, {}).update(by_path)
    rows["selective_scan"]["fleet"] = fleet_numbers
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
        for key in ("tf32", "f16_split"):
            if key in r["bound"]:
                row[f"{key}_bound_ms"] = r["bound"][key][0]
        for key in ("host_ms", "sdpa_output_only_ms", "device_kernels_per_call",
                    "device_kernels_per_call_impress", "baseline_shapes", "decode_ms",
                    "decode_host_ms", "decode_bound_ms", "falcon_decode_ms",
                    "falcon_decode_host_ms", "falcon_decode_bound_ms", "dense_ingest",
                    "falcon_prefill", "one_cta_per_sm_ms", "pools_form", "indexed",
                    "serve", "decode_batched", "fleet"):
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
