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
                batched step; run again, up to three runs, while no batch
                forms), (b) c = 4 unbatched, (c) c = 1, (d) c = 1 with
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
  5b. tp      — tensor-parallel decode on the same weights and session: (a)
                decode_attention's logsumexp (return_lse) at the dense decode
                shape (28 / 4 heads, d 128, 69 slots of 16 tokens with a pad,
                and 66 of 64) in bfloat16 and float32 against its plain
                version, out and mass the same bits with and without it, the
                stacked call timed both ways; (b) make_sharded_paged_decode
                over a mesh of the card repeated k = 1, 2, 4, 8 times at those
                shapes (b = 3: a row a shard of 8 sees alone, a row no shard
                sees) against the unsharded kernel, k = 1 bit for bit, one
                launch a shard, timed; (c) serve's CLI with --tp-decode 0 at
                c = 1 (bit for bit the run without it) and c = 4, then the
                Scheduler at full width over RealCompute(tp_mesh=...): c = 1
                bit for bit and c = 4 batched within the dense limits of the
                runs without a mesh, every decode attend one stacked_lse
                launch a layer, no plain version, p50 TTFT and TPOT beside
                the runs without; (d) make_sharded_sparse_decode_step at
                budget 1.0 on 2 shards of the card over a 4096-token serve
                state against the dense decode_step (2e-2 of the largest
                logit, JAX's test's limit);
  6. hybrid   — compute-or-load Re-Prefill and the three-tier prefix store
                on the dense phase's weights and sessions (caches of size 0
                unless named): a reference run of ContiguousKV without a
                planner; (j) force-compute, 2 requests: units recomputed,
                one flash_attention launch a layer at s = end on top of the
                plan's launches, fewer SSD bytes than the reference, the
                recomputed KV against the store (the share bit-identical and
                the largest difference), logits within the dense limits of
                the reference up to the first differing greedy token, the
                recompute op's host time, recompute_prefix_kv's, and
                flash_attention at s = end against its plain version, SDPA and
                its bound, the copy to the host timed, one more request
                profiled (device busy time, idle share), and the recomputed
                KV at ends 1024, 2048 and 4080 held to the store too (the
                share printed); (k) force-load bit for
                bit the reference; (l) auto, its HybridDecision and io_scale
                printed, held as (j) or (k) by what it chose; (m) AS-LRU
                force-compute on the coarse session over the whole prefix,
                held as (j) against AS-LRU without a planner; (n) ContiguousKV
                over a TieredPrefixStore in memory mode (HBM:DRAM:SSD 256:512:
                1024 units), 4 requests bit for bit the reference, every
                request after the first hitting all three tiers, units
                dropping out of the SSD tier and compaction moving others
                while its reads are in flight, then two tenants of one prompt
                on one store (the second hits the first's units, one payload
                copy); then serve's CLI with --hybrid-reprefill auto
                --cache-tiers 4:8:16 at concurrency 1 (2 layers, tier hits
                asserted); every run of the phase with its launches asserted
                and no plain version run;
  7. state    — flash_attention (hymba prefill, dense ingest, ragged s,
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
  8. fleet    — the heterogeneous fleet qwen2_5_7b:2,hymba_1_5b:1,
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
  9. wide     — (o) the four attention kernels at head dim 256, gemma3-4b's
                shapes (8 query heads over 4 kv heads): flash_attention over
                4096 tokens with window 0 and 1024 (the wgmma kernel's d 256
                instance), chunk_score over the prefix and
                chunk_attention over 64 chunks of 16 under a 64-token suffix
                (float32 queries; the indexed form at b = 2 bit for bit the
                gathered), decode_attention over 16-token pages (bfloat16;
                the pools form at b = 2 bit for bit the stacked), each held
                against its plain version and timed beside it, its bound,
                scaled_dot_product_attention at d 256 and its host time;
  10. moe     — (p) granite-moe-3b-a800m at full width cut to
                MOE_SERVE_LAYERS of its 32 layers (40 experts top 8, random
                bfloat16 weights from a seeded generator): the e2e phase's request shape through
                ContiguousKVEngine, launches per request and read
                amplification asserted, TTFT / TPOT, a profiled request, the
                expert assignments the ingest dropped at capacity factor
                1.25, and a budget-1.0 request against the dense forward on
                the config made dropless (capacity factor E / k: the ingest
                drops at capacity, part B does not); (q) served: 8 requests
                in a burst at c = 4 with batched decode and part B in chunks
                of 16 (launches by form asserted, no plain version; run
                again, up to three runs, while no decode batch forms), then 2
                at c = 1 bit for bit the engine's serial run;
  11. swa     — (r) gemma3-4b at full width (34 layers, 5:1 SWA-1024, d 256):
                its ingest through flash_attention's d 256 kernel with the
                window, the e2e request shape with every kernel's launches at
                d 256 asserted, a profiled request; the budget-1.0 agreement
                on the config without its window (the reference's Re-Prefill
                and tail decode ignore it);
  12. audio   — (s) musicgen-large at full width: prefill over 1024 frame
                embeddings (flash_attention at d 64, n_q = n_kv), 8
                decode_steps on embeds, held against forward over the same
                embeds (the dense limits);
  13. train   — qwen3-1.7b at full width (28 layers, d_model 2048, 16 / 8
                heads of 128, vocab 151936, qk_norm), every earlier model
                freed: (t1) flash_attention's backward kernel against its
                plain version at the training shape (bfloat16, s 4096,
                causal), with window 1024, at gemma3-4b's heads (8 / 4 of
                256, causal and window 1024: the wgmma variant's d 256
                kernels, the registers and spills of them and of the d 256
                forward from ptxas -v), at hymba-1.5b's (25 / 5 of 64) and in
                float32 at d 16, two runs bit for bit, the variant that ran
                (wgmma at bfloat16 d 64 / 128 / 256: the forward's logsumexp
                held to its plain version and its output the same bits with
                and without it), timed beside its bound (five products; the
                variant's own work beside it), SDPA's backward (or the backend's
                refusal), the plain version and its host time; (t2)
                make_train_step (grad_accum 2, no remat, lr 3e-4) on seeded
                bfloat16 weights over one fixed numpy-seeded batch of 2 x
                4096 tokens for 5 steps: the loss falls, 2 x 28 flash
                forward and backward launches a step (all wgmma), no plain
                version, step time, tokens/s, model-FLOPs utilisation,
                peak memory, one more step profiled
                (the backward kernels' share, each by name: preprocess,
                dK/dV, dQ); (t17) the dry run's count held against a live
                step: (t2)'s step counted by ``launch/roofline.py``'s
                StepAnalyzer on the card and on meta tensors (the same aten
                products, kernel work and 56 + 56 flash launches), the
                predicted bytes against max_memory_allocated and the
                roofline time against the warm step, and ``python -m
                repro_torch.launch.dryrun`` on qwen3-1.7b's train_4k cell;
                (u) a cold and a warm ContiguousKV
                request of the dense shape on the trained weights (TTFT,
                TPOT); (t3) at full width cut to 4 layers: the kernel path's
                loss and gradients against the plain path (block-wise
                attention through autograd), remat against none, grad_accum
                2 against 1, one int8-compressed step; (t4) the train CLI at
                --preset 100m resuming at step 6, and a FailureInjector
                restart bit for bit an uninterrupted run; then state-space
                training: (t5) selective_scan's backward kernel (its
                registers and spill bytes from the build's ptxas -v log,
                its CTAs an SM) against its
                plain version at hymba-1.5b's training shape (b 1, s 4096,
                d_in 3200, n 16, bfloat16), at falcon-mamba-7b's (d_in
                8192) and with an h0 and a nonzero dh_final, two runs bit for
                bit, timed beside its bound, the plain version and its host
                time, the forward with and without its carry stores the
                same bits and both timed; (t6) full-width hymba-1.5b (32
                layers, uncut) trained as (t2) for 5 steps: the loss falls,
                64 chunked scan forwards, 64 scan backwards and 64 flash
                forward and backward launches a step, step time, tokens/s,
                model-FLOPs utilisation, peak memory, one more step profiled
                (the scan backward's share, each of its kernels by name);
                (t7) hymba at 4 layers: the kernel path against the plain
                path (block-wise attention and selective_scan_ref through
                autograd) within (t3)'s limits (mamba/dt_bias within its
                own), and the scan alone (flash attention on both sides)
                within (t3)'s limits on every leaf, remat bit for bit; (t8)
                falcon-mamba-7b at full width cut to 12 of 64 layers, 3
                steps, the loss falls, launches, step time, peak memory, one
                more step profiled as (t6)'s; then the families on the
                backward's other shapes, each trained as (t2) for 3 steps at
                full width and the depth FAMILY_TRAIN_LAYERS gives it (the
                loss falls, 2 x layers flash forward and backward launches a
                step, all of the variant its heads take, no plain version,
                step time, tokens/s, model-FLOPs utilisation over each
                layer's window and an MoE's active experts, peak memory, one
                more step profiled): (t9) gemma3-4b at 12 of 34 layers (two
                whole 5:1 groups; the wgmma backward at d 256); (t10)
                gemma3-4b at 6 layers (five windowed, layer 5 global) held
                to the plain path within (t3)'s limits, remat bit for bit;
                (t11) granite-moe-3b-a800m at 24 of 32 layers (its MoE
                dispatch under grad); (t12) musicgen-large at 40 of 48
                layers on numpy-seeded frame embeddings (wgmma at d 64,
                n_q = n_kv); then training over a mesh of the card
                (``make_train_step(..., mesh=)``, each position of the mesh
                on cuda:0): (t13) full-width qwen3-1.7b on a 2 x 2 mesh
                (fsdp) for 3 tensor-parallel steps of grad_accum 2 over 4 x
                4096 seeded tokens, each layer on its tensor shard's
                weights, step 1 held to the unsharded step over the same
                rows at grad_accum 4 within twice the bfloat16 floor
                measured in the run (that step's relative distance from its
                float32 computation: loss, moments, the params' update), the
                loss falls, 8 x 28 flash forward and backward launches a
                step at 8 / 4 heads and no plain version, step ms beside the
                unsharded step's, peak memory, one layer's gathers, their
                reduce and AdamW-on-blocks ms by events; (t13b) the same
                batch on a 2 x 1 mesh, bit for bit the unsharded step; (t15)
                compressed_psum over [cuda:0] x 4 on four rows' embedding
                gradients (151936 x 2048 float32): within sum_i scale_i / 2
                of the float32 sum, bytes on the wire against float32, ms by
                events; (t14) granite-moe-3b-a800m at MOE_MESH_LAYERS layers
                on the 2 x 2 mesh for one tensor-parallel step (20 experts a
                shard): the split keeps and drops exactly what the
                microbatch's dispatch of its routing does, the loss within
                MOE_MESH_LOSS_REL of the unsharded step's; (t16) at (t4)'s restart size a 2 x 2-sharded
                checkpoint restored onto 2 x 2 and 1 x 4 bit for bit, and
                one more mesh step from it bit for bit the uninterrupted
                run's; then serving over a mesh of the card (v):
                ``make_prefill_step(cfg, mesh=)`` and
                ``make_decode_step(cfg, mesh=)`` on (t13)'s qwen3-1.7b
                weights laid out by param_shardings (fsdp), a prompt and 16
                decode steps teacher-forced on the unsharded step's greedy
                tokens, over 1 x 1 (2 x 4096 tokens) and 2 x 1 (16 x 1024)
                meshes bit for bit the unsharded steps (2 x 1 over each dp
                shard's 8 rows), 2 x 2 at 16 x 1024 (rows over data, kv
                heads over model) and at 2 x 4096 (the cache's sequence over
                data: the split attend and its combine) within twice the
                bfloat16 floor (the unsharded step's relative L2 from a
                float32 run of the same weights) in logits and cache, flash
                launches a prefill = layers x tensor shards x dp parts, no
                plain version; then full-width hymba-1.5b on 1 x 2 (25 / 5
                heads: the ceil split and the fallback gathers; 1600
                channels a shard) held the same way, its scan's chunked and
                step launches counted per shard; prefill and decode-step ms
                by events beside the unsharded steps', peak memory; and,
                inside (v) on the same qwen3-1.7b weights, ContiguousKV's
                sparse decode over meshes of the card (vs):
                ``make_sparse_decode_step(cfg, mesh=)`` at chunks of 16 and
                budget 0.05, without and with cached chunk summaries, the
                mesh prefill then 4 sparse steps teacher-forced on the
                unsharded sparse step's greedy tokens over 1 x 1 (2 x 4096)
                and 2 x 1 (16 x 1024) bit for bit the unsharded step, 2 x 2
                (2 x 4096: the cache's sequence over data, its kv heads over
                model) within twice the bfloat16 floor; the share of
                (step, layer, row) picks equal to the unsharded step's;
                flash launches = layers x tensor shards x dp parts, no plain
                version; ms a sparse step by events beside the unsharded
                sparse step's and (v)'s dense mesh decode step's, peak
                memory;
  13w. laid-out init (w) — ``init_params(cfg, generator, device,
                shardings=)`` on full-width qwen3-1.7b over a 2 x 2 mesh of
                the card (``[cuda:0] * 4``, fsdp): every block of every leaf
                bit for bit ``shard_tree(init_params(...), shardings)``'s,
                both timed to a synchronize on the mesh's devices
                (``mesh.synchronize``), the laid-out init's peak beside the
                whole tree's bytes;
  14. sim     — the discrete-event sim mode on the card's host (no tensor,
                no launch): (a) both golden timelines of tests/golden/
                reproduced event for event; (b) the headline ordering's
                modelled TTFTs at a 6000-token prefix (ContiguousKV, AS-LRU,
                AS-H2O-LFU, IMPRESS) and their ratios; (c) the e2e phase's
                request shape priced by DeviceModel() and by the H100 preset
                (DeviceModel.h100_sxm5()): modelled TTFT, TPOT and channel
                time by tag, printed beside the e2e phase's measured TTFT,
                TPOT and host time by tag (a reading); (d) the modelled
                plan of that shape against the e2e phase's real one: the
                same ops up to the first token, periods, chunks selected per
                period and probe loads;
  15. a ``{"kernels": [...]}`` JSON line with each kernel's launches on the
     paths it names (per variant where a wrapper has several), its error
     against its plain version, its times and its bound (the largest of
     bytes, products and exponentials, named), at the main path's shapes,
     (``baseline_shapes``) at the baselines' and (``head_dim_256``) at
     gemma3-4b's, with its launches there; and each backward kernel as
     its own entry: ``flash_attention_bwd`` (its launches over qwen3's and
     hymba's 5 train steps, (t9), (t11), (t12)'s 3 and the mesh steps of
     (t13), (t13b) and (t14), by path and by variant; ``dry_run`` holds
     (t17)'s numbers, ``train_over_mesh`` (t13)-(t16)'s; ``head_dim_256`` at gemma3-4b's shape and ``hymba_d64`` at
     hymba-1.5b's, each with its time, bound, design bound, SDPA's time,
     host time, errors and launches) and ``selective_scan_bwd`` (over
     hymba's 5 and falcon-mamba's 3 train steps); decode_attention's
     ``sharded`` entry holds phase 5b's numbers and its launches on (b)-(d);
     flash_attention's and selective_scan's ``serve_mesh`` entries hold
     (v)'s numbers ((vs)'s under ``sparse (vs)``), and their launches on
     (v)'s and (vs)'s paths count in theirs;
  16. last line: ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero, printing no result, without one or
outside a checkout (it builds and imports ``src/repro_torch``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
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
# (a) batches only when two plans reach their decode steps together, which
# the one-op-per-pass driver does by the timing of their chunk reads (H100
# runs formed 0 to 32 batched iterations): a run that formed none is run
# again, this many runs in all, and the last must have batched
SERVE_BATCH_TRIES = 3
# chunked prefill: the serve phase's part B in ops of 16 suffix tokens, the
# state-space request's prefill in ops of 1024 tokens; the indexed form's
# paged case: valid chunks of the 64 indices into a layer's pool
SERVE_PREFILL_CHUNK, STATE_PREFILL_CHUNK, INDEXED_PAGED_VALID = 16, 1024, 57
# compute-or-load: requests of each planner run; the tier store's HBM:DRAM:SSD
# capacities in units (one request selects 64 chunks x 28 layers = 1792, so
# its units spill past HBM and DRAM into the SSD tier, which overflows: units
# drop out of the log and compaction moves the survivors while reads of the
# SSD tier are in flight), and the two tenants' store, whose HBM holds one
# request's units; serve's CLI on the card: its tier capacities and requests
HYBRID_REQUESTS, TIER_CAPS, SHARED_TIER_CAPS = 2, (256, 512, 1024), (2048, 0, 0)
CLI_TIER_CAPS, CLI_REQUESTS = "4:8:16", 4
# frontiers below the prefix length at which the recomputed KV is also held
# to the store (GEMMs over fewer rows than the ingest's)
KV_CHECK_ENDS = (1024, 2048, 4080)
# the heterogeneous fleet: tenants by model, requests (tenant 1 + rid % 4, so
# two a tenant) and decode tokens each
FLEET_SPEC, FLEET_REQUESTS, FLEET_DECODE = "qwen2_5_7b:2,hymba_1_5b:1,falcon_mamba_7b:1", 8, 8
# a batched part B's h against the single one's: the same attention bit for
# bit, then float32 GEMMs over b * 64 rows instead of 64, which cuBLAS may
# sum in another order (sums of 3584 and 18944 products): a few float32
# ulps of the largest value are expected, 1e-5 of it is the kernels' limit
PART_B_BATCH_REL = 1e-5
# tensor-parallel decode (phase 5b): the mesh's shard counts over the card;
# pool pages at each page size (the table one pad slot past its pages: 69
# slots at 16-token pages, the dense decode shape); requests of the
# full-width serve runs and of serve's CLI; the logsumexp against its plain
# version (float32 sums of the same exponentials in another order, a few
# ulps of a value near 7); the sharded sparse step at budget 1.0 against the
# dense decode_step, JAX's test's limit (tests/test_sharded_sparse.py)
TP_SHARDS, TP_POOL_PAGES = (1, 2, 4, 8), {16: 70, 64: 67}
TP_SERVE_REQUESTS, TP_CLI_REQUESTS = 4, 4
DECODE_LSE_TOL, TP_SPARSE_REL = 1e-5, 2e-2
# The same check as served, in bfloat16: both sides round every op to
# bfloat16 through 32 layers in different orders (GEMV against GEMM, the
# decode's bfloat16 scores against flash_attention's float32 ones, decode's
# float32 dt against prefill's bfloat16 dt), some 600 roundings of 2^-9 in a
# random walk: ~0.05 of the largest logit. An H100 run measured 0.0517 and
# cosine 0.99904 at step 1; the limits leave about 2x room
STEP_BF16_REL_TOL, STEP_BF16_MIN_COS = 0.1, 0.998
# the new families: granite-moe-3b-a800m served (requests of its burst at
# c = 4), gemma3-4b's d 256 heads, musicgen-large's frame embeddings
MOE_NAME, SWA_NAME, AUDIO_NAME = "granite-moe-3b-a800m", "gemma3-4b", "musicgen-large"
MOE_SERVE_REQUESTS, AUDIO_FRAMES, AUDIO_DECODE = 8, 1024, 8
# (p)-(q) serve granite cut in depth for the run's time limit: at all 32
# layers they took 104.1 s of an 853 s run on an H100 (a slower host ran the
# whole script in 1136 s of the 1200 allowed); 16 layers keep every path
MOE_SERVE_LAYERS = 16
# training (phase t): qwen3-1.7b at full width, make_train_step over one
# fixed batch of TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_ACCUM microbatches;
# the backward kernel also with a sliding window of BWD_WINDOW
TRAIN_NAME, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = "qwen3-1.7b", 2, 4096, 2
TRAIN_STEPS, TRAIN_LR, BWD_WINDOW = 5, 3e-4, 1024
# the backward kernel in float32 against its plain version: the same float32
# sums in other orders (1e-5 of each gradient's largest element); 16-bit
# inputs FLASH_REL: cuda_core_f32 rounds each gradient's float32 result once,
# wgmma also rounds P and dS to 16 bits before its dV, dK and dQ products
# (on an H100 one bfloat16 ulp of the largest gradient: 0.58-0.68 of the
# limit causal, 0.45-0.8 with window 1024, dq the closest)
BWD_F32_REL = 1e-5
# the wgmma forward's logsumexp (log2 units) against its plain version:
# float32 sums of up to 4096 exponentials in another order, ex2.approx and
# log2f; 2e-5 is a relative 1.4e-5 on each P (an H100 run measured 1.9e-6)
LSE_TOL = 2e-5
# the backward's work over the visible pairs: (products, exponentials) of
# the function, S, dP, dV, dK and dQ with one exponential a pair (the
# bound), and of each variant's design (``design_bound_ms``): wgmma
# computes S and P (and dP) in both of its gradient kernels, cuda_core_f32 S
# and P in its stats pass too
BWD_WORK = (5, 1)
BWD_DESIGN_WORK = {"wgmma": (7, 2), "cuda_core_f32": (8, 3)}
# (t1)'s other shapes: gemma3-4b's heads (query, kv, head dim; d 256 trains
# on the wgmma backward) and hymba-1.5b's, whose flash backward runs 64
# times in a training step
SWA_HEADS, SSM_HEADS = (8, 4, 256), (25, 5, 64)
# (t3) the kernel path against the plain path in bfloat16 at full width, 4
# layers: the plain path rounds the scores to bfloat16 before its float32
# softmax and P to bfloat16 before P V, the kernels keep both in float32 and
# round each gradient once, so the two differ by bfloat16 rounding through 4
# layers' backward. An H100 run measured the loss 1.5e-5 apart, cosine
# >= 0.99976 and ||g_k - g_p|| / ||g_p|| <= 0.0221 on every leaf; the
# limits: the loss within 1e-4 relative, each leaf at cosine >= 0.99 (a cut
# graph gives 0 on wq, wk, wv) and within 0.05 in that norm ratio, which
# also sees a gradient off by a constant factor (cosine 1)
AGREE_LAYERS, AGREE_LOSS_REL, AGREE_MIN_COS, AGREE_MAX_REL_NORM = 4, 1e-4, 0.99, 0.05
# grad_accum 2 against 1 on one batch: the same kernels, GEMMs over half the
# rows (cuBLAS may sum in another order) and bfloat16 gradients summed in
# float32 instead of one bfloat16 rounding of the whole batch's
ACCUM_LOSS_REL, ACCUM_MIN_COS = 1e-3, 0.999
# (t4) the restart check's model: qwen3's head dim and bfloat16, 4 layers
RESTART_ARCH = "qwen3-1.7b"
RESTART_OVERRIDES = dict(n_layers=4, d_model=512, d_ff=1536, vocab_size=4096, n_heads=4,
                         n_kv_heads=2, d_head=128, dtype="bfloat16")
# training over a mesh (t13)-(t16): qwen3-1.7b on a 2 x 2 mesh of the card
# for MESH_STEPS tensor-parallel steps of grad_accum MESH_ACCUM over
# MESH_BATCH rows of TRAIN_SEQ tokens (one row a dp shard a microbatch),
# granite-moe-3b-a800m at MOE_MESH_LAYERS layers over MESH_BATCH rows of
# MOE_MESH_SEQ (its unsharded reference runs 2-row microbatches: 4096 tokens
# each, (t11)'s microbatch; 16 layers peaked at 44.0 GiB unsharded on an
# H100)
MESH_BATCH, MESH_ACCUM, MESH_STEPS = 4, 2, 3
MOE_MESH_LAYERS, MOE_MESH_SEQ = 16, 2048
# (t13)'s step 1 against the unsharded step over the same rows (each dp
# part's rows one unsharded microbatch): the tensor shards' row-parallel
# partials round to bfloat16 before their float32 sum, as GSPMD's do, so the
# two are two bfloat16 roundings of one step. The limit is MESH_FLOOR_X
# times the floor measured in the run, the unsharded step's own relative
# distance from a float32 computation of the same step (moments, params'
# update, and the positions' log-likelihoods for the loss), as (v) holds
# serving. (t13b), one tensor shard: the
# parts' gradients weighed by an exact 1/2 and summed in float32 are the
# microbatches' summed and divided by 4, bit for bit
MESH_FLOOR_X = 2.0
# (t14)'s loss against the unsharded step: a part's GEMMs run over 2048
# rows where the microbatch's run over 4096, and cuBLAS sums those in other
# orders, so a router logit near a tie flips and the queue positions after
# it shift (an H100 run of the dp-only mesh step: 1.8 % of granite's
# assignments kept or dropped otherwise, the loss 7.5e-6 apart; of the
# tensor-parallel one, whose shards' bfloat16 partials add (t13)'s
# rounding: 4.0 % and 1.63e-5); 1e-4 leaves ~6x room
MOE_MESH_LOSS_REL = 1e-4
# (v) serving over a mesh of the card (make_prefill_step / make_decode_step
# with mesh=, launch/tp_compute.py): a prompt then SERVE_MESH_DECODE decode
# steps teacher-forced on the unsharded step's greedy tokens, over a cache of
# the prompt and the decode steps. Cases (data, model, batch, prompt): 1 x 1
# and 2 x 1 bit for bit the unsharded steps (2 x 1 over each dp shard's 8
# rows); elsewhere the logits and each cache leaf within SERVE_MESH_FLOOR_X
# times the bfloat16 floor in relative L2 of the unsharded step's, the floor
# being the unsharded step's own relative L2 from a float32 run of the same
# weights on the same tokens (the row-parallel partials round in bfloat16
# before their float32 sum, as GSPMD's bfloat16 partials do: two bfloat16
# roundings of one function, each about as far from float32 as the other;
# a CPU run of a reduced qwen3 measured the floor at 0.015-0.017, the mesh
# 0.011-0.016 from the unsharded step, 0.015-0.017 from float32), and a
# row's argmax equal wherever its unsharded top-2 margin exceeds 4x the
# row's largest logit difference
SERVE_MESH_DECODE, SERVE_MESH_FLOOR_X = 16, 2.0
SERVE_MESH_CASES = ((1, 1, 2, 4096), (2, 1, 16, 1024), (2, 2, 16, 1024), (2, 2, 2, 4096))
SERVE_MESH_HYBRID = ((1, 2, 2, 4096),)  # hymba-1.5b: 25 / 5 heads, 1600 channels a shard
# (vs) ContiguousKV's sparse decode over meshes of the card, inside (v) on its
# qwen3-1.7b weights: the dry run's chunks and budget, SPARSE_MESH_STEPS
# steps after the mesh prefill, the cache's capacity the prompt and the
# steps rounded up to a multiple of its sequence blocks x chunk_tokens; 1 x 1
# and 2 x 1 (at 16 rows) bit for bit, 2 x 2 within (v)'s limit
SPARSE_MESH_STEPS, SPARSE_MESH_CHUNK, SPARSE_MESH_BUDGET = 4, 16, 0.05
SPARSE_MESH_CASES = ((1, 1, 2, 4096), (2, 1, 16, 1024), (2, 2, 2, 4096))
# on a mesh with tensor shards the bfloat16 picks follow rounding (random
# weights' chunk means lie close: a first H100 run matched 0.406 of the
# unsharded step's); a float32 run of the mesh on the same tokens separates
# that from a wrong pick, which would miss most of the float32 step's picks
# (the CPU tests hold every float32 pick equal at reduced size)
SPARSE_MESH_F32_PICKS = 0.9
# state-space training (t5)-(t8): hymba-1.5b at full width and depth for
# TRAIN_STEPS steps, falcon-mamba-7b at full width cut to FALCON_TRAIN_LAYERS
# of its 64 layers for FALCON_TRAIN_STEPS steps, on (t2)'s batch shape. The
# full 7.0 B with AdamW's float32 moments does not fit one 80 GB card; 16
# layers (2.15 B) ran out of memory on an H100 in step 1's AdamW update
# (70.6 GiB allocated, a 4 GiB float32 temporary of the stacked w_in leaf
# wanted), so 12 (1.75 B)
SSM_TRAIN_NAME, FALCON_TRAIN_NAME = "hymba-1.5b", "falcon-mamba-7b"
FALCON_TRAIN_LAYERS, FALCON_TRAIN_STEPS = 12, 3
# (t5) the scan's backward against its plain version. dx, ddt, dB and dC are
# bfloat16, each a float32 result rounded once, as the plain version's is,
# so the two round at most one bfloat16 ulp apart: FLASH_REL of each
# gradient's largest element (ddt's float32 sums of d_in x n = 51,200
# (hymba) and 131,072 (falcon-mamba) terms a position are re-associated,
# far below that ulp). dA and dh0 stay float32: sums over 4096 positions of
# terms carrying h and g from recurrences re-associated in chunks, and the
# kernel's ex2.approx a; a first H100 run measured 6.1e-6 (hymba) and
# 1.1e-5 (falcon-mamba) of the largest element: 5e-5 leaves 4x room
SCAN_BWD_F32_REL = 5e-5
SCAN_BWD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")
B_LOG = "build/kernels/build.log"
# float32 operations a (position, channel, state) element of the backward
# needs at least: a and h_t again (4), g and q (3), and the five gradient
# terms with their sums (12); an FMA counts 2
SCAN_BWD_OPS = 19
# (t7) hymba at 4 layers, the kernel path against the plain path: (t3)'s
# limits, but for mamba/dt_bias (cosine, norm ratio): its gradient is one
# scalar a layer, the sum over 4096 positions of terms that cancel, so the
# attention path's bfloat16 differences (block-wise attention rounds its
# scores and P to bfloat16, flash keeps them in float32) reach it amplified.
# An H100 run measured cosine 0.9806 and norm ratio 0.250 on it (every other
# leaf >= 0.99976 and <= 0.0219), and 0.030 with the attention the same on
# both sides (the scan alone, held to (t3)'s limits on every leaf); the
# limits leave 2x room
DT_BIAS_LIMITS = (0.95, 0.5)
# (t9)-(t12): the new families trained as (t2) for FAMILY_TRAIN_STEPS steps,
# each at the depth below. A step holds ~24 bytes a parameter at its AdamW
# update (bfloat16 weights old and new, float32 gradient accumulators, the
# old and the new float32 moments), where the card has ~79 GiB: gemma3-4b's
# 4.55 B (1.34 B of them its untied vocab-262144 embed and unembed) would
# want ~109 GB, so two whole 5:1 groups (12 layers, 2.48 B, layers 5 and 11
# global), which peaked at 70.5 GiB on an H100 (its head's float32 logits,
# log-softmax and their gradients, 4.3 GB each, in the backward): 18 layers
# would not fit; granite-moe-3b-a800m's 3.37 B would want ~81 GB, and at 16
# layers it peaked at 44.0 GiB in its backward (~1.1 GiB of MoE dispatch
# activations a layer), so 24 of 32 (2.57 B, ~66 GiB predicted); musicgen-
# large's 3.22 B ~77 GB, so 40 of 48 layers (2.69 B, 66.5 GiB measured)
FAMILY_TRAIN_STEPS, SWA_AGREE_LAYERS = 3, 6
FAMILY_TRAIN_LAYERS = {SWA_NAME: 12, MOE_NAME: 24, AUDIO_NAME: 40}
FAMILY_TRAIN_DEPTH_WHY = {
    SWA_NAME: "two whole 5:1 groups (layers 5 and 11 global); the full 4.55 B with AdamW "
              "would want ~109 GB, and 12 layers peak at ~70 GiB",
    MOE_NAME: "the full 3.37 B with AdamW would want ~81 GB before its MoE dispatch's "
              "activations (~1.1 GiB a layer)",
    AUDIO_NAME: "the full 3.22 B with AdamW would want ~77 GB at its update"}


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


def work_bounds(name: str, **shapes):
    """``bounds`` of one call of kernel ``name``: its bytes, products and
    exponentials as ``kernels/work.py``'s ``kernel_work`` counts them."""
    from repro_torch.kernels.work import kernel_work

    w = kernel_work(name, **shapes)
    return bounds(w.bytes, w.products, w.exponentials)


def flash_shapes(q, k, **kw) -> dict:
    """A flash call's shapes as ``kernel_work`` takes them."""
    b, n_q, s_q, d = q.shape
    return dict(b=b, n_q=n_q, n_kv=k.shape[1], s_q=s_q, s_k=k.shape[2], d=d,
                itemsize=q.element_size(), **kw)


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


def device_events(prof):
    """[(key, calls, device us)] of a torch.profiler session's device events
    (the time attribute's name changed across torch versions)."""
    import torch

    out = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            out.append((e.key, e.count, e.self_cuda_time_total if t is None else t))
    return out


def kernel_name(key: str) -> str:
    """A kernel's own name in its profiler key, without namespace, template
    arguments and parameters (which may name ckv:: types too)."""
    return key.split("(")[0].split("ckv::")[-1].split("<")[0]


def ptxas_info(fragment: str) -> dict:
    """{mangled name: (registers, spill store bytes, spill load bytes)} of
    every device function whose mangled name holds ``fragment``, as ptxas -v
    reported them in the kernels' build log."""
    from repro_torch.kernels import build as B

    lines = (B.BUILD_DIR / "build.log").read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or fragment not in line:
            continue
        name = line.split("'")[1]
        regs = spills = None
        for nxt in lines[i + 1: i + 5]:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
            spills = (int(m[1]), int(m[2])) if m else spills
            m = re.search(r"Used (\d+) registers", nxt)
            regs = int(m[1]) if m else regs
        out[name] = (regs, *spills)
    return out


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


def phase_kernels(cfg, tag: str = "kernels"):
    """Each kernel against its plain version at the main path's shapes
    (``cfg``'s heads), printed under ``tag``."""
    import torch

    from repro_torch.kernels.chunk_attention.ops import chunk_attention
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.chunk_score.ops import chunk_score
    from repro_torch.kernels.chunk_score.ref import chunk_score_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = torch.device(DEVICE)
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
            fail(f"{tag}: chunk_score {dname(q)} n={n}: max abs err {err} > {tol}")
        if not torch.equal(got, chunk_score(q, kk, CHUNK)):
            fail(f"{tag}: chunk_score is not reproducible bit for bit")
        print(f"{tag}: chunk_score q {dname(q)} n={n}: max abs err {err:.3g} "
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
            fail(f"{tag}: chunk_attention {dname(q)} n_valid={n_valid}: err {err} > {tol}")
        print(f"{tag}: chunk_attention q {dname(q)} chunks {n_valid}/{n_sel}: "
              f"max abs err {err:.3g} (tol {tol:.3g}) on out and A_j")
        if not (torch.equal(o, chunk_attention(q, ks, vs, n_valid, kf, vf)[0])
                and torch.equal(ms, chunk_attention(q, ks, vs, n_valid, kf, vf)[1])):
            fail(f"{tag}: chunk_attention is not reproducible bit for bit")
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
        fail(f"{tag}: decode_attention: a pad slot changed the real pages' results")
    # bfloat16 output: both round one float32 result, so one bfloat16 ulp
    err_o, tol_o = max_err(o, o2), 2.0 ** -7 * o2.float().abs().max().item()
    err_m, tol_m = max_err(pm, pm2), 1e-5 * pm2.abs().max().item() + 1e-7
    if not (err_o <= tol_o and err_m <= tol_m):
        fail(f"{tag}: decode_attention: err out {err_o} > {tol_o} or mass {err_m} > {tol_m}")
    print(f"{tag}: decode_attention bfloat16 {n_pages - 1} pages + 1 pad slot: max abs "
          f"err out {err_o:.3g} (tol {tol_o:.3g}), mass {err_m:.3g} (tol {tol_m:.3g}); "
          f"pad slot bit-identical")
    o2, pm2 = decode_attention(q, kp, vp, wide, lens)
    if not (torch.equal(o, o2) and torch.equal(pm, pm2)):
        fail(f"{tag}: decode_attention is not reproducible bit for bit")
    rows["decode_attention"] = decode_attention_timing(q, kp, vp, wide, lens, o, pm,
                                                       max(err_o, err_m))
    print(f"{tag}: decode_attention two runs bit-identical")
    for name, r in rows.items():
        extra = f"; host time per call {r['host_ms']:.4f} ms"
        if "sdpa_output_only_ms" in r:
            extra += (f"; output-only scaled_dot_product_attention "
                      f"{r['sdpa_output_only_ms']:.4f} ms")
        print(f"{tag}: {name}: {r['ms']:.4f} ms on the card (plain version "
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
                bound=work_bounds("decode_attention", b=q.shape[0], n_q=nq, n_kv=nkv, d=d,
                                  n_active=table.shape[1], tokens=L,
                                  itemsize=q.element_size()))


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
    for run in range(1, SERVE_BATCH_TRIES + 1):
        done_a, sched_a, taps_a, got_a, s_a, tr_a = serve("(a) c=4 batched", 4, meter=True)
        if sched_a.real_batch_log or run == SERVE_BATCH_TRIES:
            break
        print(f"serve (a): run {run} of at most {SERVE_BATCH_TRIES} formed no batched "
              f"iteration (no two plans reached their decode steps together); run again")
    done_b, _, taps_b, got_b, s_b, _ = serve("(b) c=4 unbatched", 4, batch=False, meter=True)
    record("(a) c=4 batched", got_a)
    record("(b) c=4 unbatched", got_b)
    batches = sched_a.real_batch_log
    if not batches or min(len(m) for m in batches) < 2:
        fail(f"serve (a): batched iterations {[len(m) for m in batches]} in run {run}")
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
          f"members in run {run}; decode_attention launches by form {by_form}; decode steps' "
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


def _tp_decode_inputs(cfg, dtype, page, seed):
    """``cfg``'s decode shape at ``page``-token pages, b = 3: row 0
    over a shuffled pool of TP_POOL_PAGES pages, its table one pad slot past
    its pages, its last page partial; row 1 over 5 pages that all lie in the
    pool's first eighth (of k <= 8 shards only shard 0 sees it); row 2 of
    length 0 (no shard sees anything)."""
    import numpy as np
    import torch

    n_pages = TP_POOL_PAGES[page]
    width = n_pages - 1
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = rn(3, cfg.n_heads, cfg.d_head)
    kp, vp = (rn(3, n_pages, page, cfg.n_kv_heads, cfg.d_head) for _ in range(2))
    rng = np.random.default_rng(seed)
    tbl = np.full((3, width), -1, np.int32)
    tbl[0, : width - 1] = rng.permutation(n_pages)[: width - 1]
    tbl[1, :5] = rng.permutation(n_pages // 8)[:5]
    tbl[2, :3] = [0, n_pages // 2, n_pages - 1]
    lens = [(width - 2) * page + 5, 4 * page + 1, 0]
    return (q, kp, vp, torch.from_numpy(tbl).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def phase_tp(cfg, ctx, smi_line):
    """Tensor-parallel decode on the dense phase's weights and session, as
    the module docstring's phase 5b says. Returns ({kernel: {path:
    launches}}, decode_attention's ``sharded`` entry for the kernels line)."""
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss

    t0 = time.perf_counter()
    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da,
           "flash_attention": fa, "selective_scan": ss}
    entry = {"lse": _tp_lse(cfg), "attend": _tp_attend(cfg, smi_line)}
    with plain_versions_counted(ops) as plain_calls:
        paths, entry["serve"] = _tp_serve(cfg, ctx, smi_line, ops, plain_calls)
    entry["sparse_step"] = _tp_sparse_step(cfg, ctx, smi_line)
    entry["launches"] = {"(b) attend, all k": entry["attend"].pop("launches"),
                         "(c) serve": sum(p["launches"]
                                          for p in paths["decode_attention"].values()),
                         "(d) sparse step": entry["sparse_step"].pop("launches")}
    print(f"tp: phase took {time.perf_counter() - t0:.1f} s")
    return paths, entry


def _tp_lse(cfg):
    """(a) decode_attention's logsumexp at the dense decode shape, 16- and
    64-token pages, bfloat16 and float32: lse within DECODE_LSE_TOL of the
    plain version's, out and mass the same bits with and without it, and the
    stacked call timed with and without it."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    out = {}
    for page in (CHUNK, BLOCK):
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, tbl, lens = (x[:1] for x in _tp_decode_inputs(cfg, dtype, page, 11))
            o, m, lse = da.decode_attention(q, kp, vp, tbl, lens, return_lse=True)
            o2, m2 = da.decode_attention(q, kp, vp, tbl, lens)
            if not (torch.equal(o, o2) and torch.equal(m, m2)):
                fail(f"tp (a): decode_attention page {page} {dname(q)}: out or mass changed "
                     f"with return_lse")
            _, _, want = decode_attention_ref(q, kp, vp, tbl, lens, return_lse=True)
            err = max_err(lse, want)
            if not (err <= DECODE_LSE_TOL and torch.isfinite(lse).all()):
                fail(f"tp (a): decode_attention page {page} {dname(q)}: lse err {err} > "
                     f"{DECODE_LSE_TOL}")
            ms = device_ms(lambda: da.decode_attention(q, kp, vp, tbl, lens))
            ms_lse = device_ms(lambda: da.decode_attention(q, kp, vp, tbl, lens,
                                                           return_lse=True))
            key = f"page {page} {dname(q)}"
            out[key] = dict(lse_err=err, ms=ms, lse_ms=ms_lse, tokens=int(lens.item()))
            print(f"tp (a): decode_attention {key}, {int(lens.item())} tokens over "
                  f"{tbl.shape[1]} slots (one a pad): lse max abs err {err:.3g} (tol "
                  f"{DECODE_LSE_TOL}) against the plain version, out and mass bit-identical "
                  f"with and without it; stacked call {ms:.4f} ms, with the logsumexp "
                  f"{ms_lse:.4f} ms")
    return out


def _tp_attend(cfg, smi_line):
    """(b) make_sharded_paged_decode over [card] x k, k in TP_SHARDS, at the
    dense decode shape (b = 3, see _tp_decode_inputs): against the unsharded
    kernel (float32 within 1e-5 of the largest output, bfloat16 within
    FLASH_REL: each shard's output and the combine each round once; mass
    within 1e-5), k = 1 bit for bit, one stacked_lse launch a shard, the row
    no shard sees 0; timed per call beside the unsharded call."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.sharded_sparse import make_sharded_paged_decode

    out = {"launches": 0}
    for page in (CHUNK, BLOCK):
        for dtype in (torch.bfloat16, torch.float32):
            args = _tp_decode_inputs(cfg, dtype, page, 12)
            want_o, want_m = da.decode_attention(*args)
            rel = 1e-5 if dtype == torch.float32 else FLASH_REL
            key = f"page {page} {dname(args[0])}"
            q, kp, _, tbl, lens = args
            n_tok = int(lens.sum())  # each row's valid tokens lie in its table's pages
            bound = work_bounds("decode_attention", b=q.shape[0], n_q=q.shape[1],
                                n_kv=kp.shape[3], d=kp.shape[4], n_active=tbl.shape[1],
                                tokens=n_tok, itemsize=q.element_size())
            row = {"unsharded_ms": device_ms(lambda: da.decode_attention(*args)),
                   "bound_ms": bound["tensor_core"][0], "bound_by": bound["tensor_core"][1]}
            print(f"tp (b) {key}: {n_tok} valid tokens over b = 3, {bound_text(bound)}")
            for k in TP_SHARDS:
                attend = make_sharded_paged_decode(make_serving_mesh(
                    devices=[torch.device(DEVICE)] * k))
                before = da.launches_by_variant["stacked_lse"]
                o, m = attend(*args)
                launches = da.launches_by_variant["stacked_lse"] - before
                out["launches"] += launches
                err_o, err_m = max_err(o, want_o), max_err(m, want_m)
                tol_o = rel * want_o.float().abs().max().item()
                tol_m = 1e-5 * want_m.abs().max().item()
                if not (err_o <= tol_o and err_m <= tol_m and launches == k):
                    fail(f"tp (b) {key} k={k}: err out {err_o} (tol {tol_o}), mass {err_m} "
                         f"(tol {tol_m}), {launches} launches")
                if k == 1 and not (torch.equal(o, want_o) and torch.equal(m, want_m)):
                    fail(f"tp (b) {key}: one shard is not bit for bit the unsharded kernel")
                if o[2].abs().max().item() or m[2].abs().max().item():
                    fail(f"tp (b) {key} k={k}: the row no shard sees is not 0")
                ms = device_ms(lambda: attend(*args))
                row[k] = dict(ms=ms, busy_ms=_busy_ms(lambda: attend(*args)),
                              host_ms=host_ms(lambda: attend(*args)), err_out=err_o,
                              err_mass=err_m, launches_per_call=launches)
                print(f"tp (b) {key} k={k}: max abs err out {err_o:.3g} (tol {tol_o:.3g}), "
                      f"mass {err_m:.3g} (tol {tol_m:.3g}) against the unsharded kernel"
                      f"{', bit-identical' if k == 1 else ''}; {ms:.4f} ms a call by events "
                      f"(unsharded {row['unsharded_ms']:.4f} ms), its kernels busy "
                      f"{row[k]['busy_ms']:.4f} ms and its host {row[k]['host_ms']:.4f} ms a "
                      f"call, {launches} launches a call ({smi_line})")
            out[key] = row
    return out


def _busy_ms(fn, calls: int = 10) -> float:
    """The device time of the kernels one call of ``fn`` runs, summed
    (torch.profiler over ``calls`` calls, after a spin kernel it does not
    count): no idle gap between them counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # a session may lose its first launch: let it be this one
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(us for key, _, us in device_events(prof) if "spin_kernel" not in key) / calls / 1e3


def _tp_serve(cfg, ctx, smi_line, ops, plain_calls):
    """(c) serve with --tp-decode 0: serve's CLI (2 layers, as the hybrid
    phase runs it) at c = 1 and c = 4, the flag against none; then the
    Scheduler at full width over RealCompute(tp_mesh=make_serving_mesh()),
    c = 1 bit for bit and c = 4 batched within the dense limits of the runs
    without a mesh, every decode attend one stacked_lse launch a layer."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import Request, Scheduler, summarize
    from repro_torch.storage.timing import RealExecutor

    L, V = cfg.n_layers, cfg.vocab_size
    paths, numbers = {}, {}
    base = ["--device", DEVICE, "--arch", cfg.name, "--n-layers", "2", "--requests",
            str(TP_CLI_REQUESTS), "--decode-tokens", "3"]
    for c in (1, 4):
        runs = {}
        for flag in ((), ("--tp-decode", "0")):
            buf = io.StringIO()
            reset_counts(*ops.values())
            plain_calls.clear()
            with contextlib.redirect_stdout(buf):
                runs[flag] = serve_cli.main(base + ["--concurrency", str(c), *flag])
            got = counts(ops["decode_attention"])
            if plain_calls or (flag and set(got) != {"launches", "stacked_lse"}):
                fail(f"tp (c) CLI c={c} {flag}: decode_attention {got}, plain {plain_calls}")
            if flag:
                paths.setdefault("decode_attention", {})[f"tp (c) serve CLI c={c}"] = got
                if "tensor-parallel decode: 1 devices, mesh {'model': 1}" not in buf.getvalue():
                    fail(f"tp (c) CLI: no mesh line:\n{buf.getvalue()}")
        a, b = runs[()], runs[("--tp-decode", "0")]
        worst = max(logit_agreement(x.result[0, -1], y.result[0, -1])[0] for x, y in zip(a, b))
        if c == 1 and not all(np.array_equal(x.result, y.result)
                              and x.trace.decode_tokens_out == y.trace.decode_tokens_out
                              for x, y in zip(a, b)):
            fail("tp (c) CLI c=1: --tp-decode 0 is not bit for bit the run without it")
        if not worst <= DENSE_REL_TOL:
            fail(f"tp (c) CLI c={c}: last logits max err / max |logit| {worst}")
        print(f"tp (c) serve CLI --tp-decode 0 c={c} ({len(b)} requests, 2 layers): "
              f"{'bit-identical to' if c == 1 else 'within the dense limits of'} the run "
              f"without it (last logits {worst:.3g} of the largest)")

    params, sess = ctx["params"], ctx["sess"]
    rng = np.random.default_rng(7)  # the serve phase's suffixes
    suffixes = [rng.integers(0, V, SUFFIX_LEN) for _ in range(TP_SERVE_REQUESTS)]
    mesh = make_serving_mesh(devices=None if DEVICE == "cuda" else [torch.device(DEVICE)])

    def run(label, c, tp):
        eng = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE,
                                                   tp_mesh=mesh if tp else None),
                                 RealExecutor(), budget=BUDGET, period=PERIOD,
                                 subperiod=SUBPERIOD)
        taps = _tapped(eng)
        reqs = [Request(request_id=i, suffix=s, decode_tokens=DECODE_TOKENS)
                for i, s in enumerate(suffixes)]
        sched = Scheduler(eng, policy="fcfs", max_concurrency=c, batch_decode=True)
        reset_counts(*ops.values())
        plain_calls.clear()
        done = sched.run(reqs)
        torch.cuda.synchronize()
        eng.ex.shutdown()
        got = {k: counts(mod) for k, mod in ops.items()}
        if plain_calls:
            fail(f"tp (c) {label}: plain versions ran on the card: {plain_calls}")
        for cr in done:
            if cr.result.shape != (1, 1, V) or not np.isfinite(cr.result).all():
                fail(f"tp (c) {label} request {cr.request.request_id}: bad output")
        s = summarize(done)
        sizes = [len(m) for m in sched.real_batch_log]
        execs = TP_SERVE_REQUESTS * DECODE_TOKENS - sum(sizes) + len(sizes)
        da_got = got["decode_attention"]
        if tp:
            want = {"launches": execs * L, "stacked_lse": execs * L}
            if da_got != want:
                fail(f"tp (c) {label}: decode_attention launches {da_got}, expected {want} "
                     f"({execs} decode executions x {L} layers)")
            paths.setdefault("decode_attention", {})[f"tp (c) {label}"] = da_got
        print(f"tp (c) {label}: {TP_SERVE_REQUESTS} requests, p50 TTFT "
              f"{s['p50_ttft'] * 1e3:.2f} ms, mean TPOT {s['mean_tpot'] * 1e3:.3f} ms, "
              f"{len(sizes)} batched iterations, decode_attention {da_got} ({smi_line})")
        return done, taps, s, sizes

    for c in (1, 4):
        d0, t0_, s0, _ = run(f"c={c} no mesh", c, False)
        d1, t1_, s1, sizes = run(f"c={c} tp mesh {dict(mesh.shape)}", c, True)
        worst = (0.0, 1.0)
        agree = 0
        for i in range(TP_SERVE_REQUESTS):
            if not np.array_equal(t0_[i]["first"], t1_[i]["first"]):
                fail(f"tp (c) c={c} request {i}: first-token logits differ with the mesh")
            rel, cos = logit_agreement(t1_[i]["steps"][0][0, -1], t0_[i]["steps"][0][0, -1])
            worst = (max(worst[0], rel), min(worst[1], cos))
            agree += sum(x == y for x, y in zip(d0[i].trace.decode_tokens_out,
                                                d1[i].trace.decode_tokens_out))
            if c == 1 and not (np.array_equal(d0[i].result, d1[i].result)
                               and d0[i].trace.decode_tokens_out
                               == d1[i].trace.decode_tokens_out):
                fail(f"tp (c) c=1 request {i}: not bit for bit the run without a mesh")
        if not (worst[0] <= DENSE_REL_TOL and worst[1] >= DENSE_MIN_COS):
            fail(f"tp (c) c={c}: first decode step max err / max |logit| {worst[0]}, cosine "
                 f"{worst[1]}")
        n_tok = TP_SERVE_REQUESTS * DECODE_TOKENS
        print(f"tp (c) c={c}: first-token logits bit-identical with and without the mesh"
              f"{', and logits and greedy tokens of every request' if c == 1 else ''}; first "
              f"decode step, worst request: max abs err / max |logit| {worst[0]:.4g} (tol "
              f"{DENSE_REL_TOL}), cosine {worst[1]:.6f}; greedy tokens agreeing {agree} of "
              f"{n_tok}; p50 TTFT {s1['p50_ttft'] * 1e3:.2f} vs {s0['p50_ttft'] * 1e3:.2f} ms, "
              f"mean TPOT {s1['mean_tpot'] * 1e3:.3f} vs {s0['mean_tpot'] * 1e3:.3f} ms "
              f"(mesh vs none; {smi_line})")
        numbers[f"c={c}"] = {"p50_ttft_ms": s1["p50_ttft"] * 1e3,
                             "no_mesh_p50_ttft_ms": s0["p50_ttft"] * 1e3,
                             "mean_tpot_ms": s1["mean_tpot"] * 1e3,
                             "no_mesh_mean_tpot_ms": s0["mean_tpot"] * 1e3,
                             "first_step_rel_err": worst[0], "batched_iterations": len(sizes)}
    if not paths.get("decode_attention"):
        fail("tp (c): decode_attention never launched on the tensor-parallel path")
    return paths, numbers


def _tp_sparse_step(cfg, ctx, smi_line):
    """(d) make_sharded_sparse_decode_step at budget 1.0 on a 2-shard mesh of
    the card over a full-width serve state of the PREFIX_LEN-token prefix
    (the capacity rounded up to whole chunks on both shards), held to the
    port's dense decode_step on a copy of the same state within
    TP_SPARSE_REL of the largest logit (JAX's test's limit). Both run on
    float32 copies of the weights, as JAX's test runs a float32 model: in
    bfloat16 the two round differently through 28 layers (float32 attention
    against the dense step's bfloat16 scores; an H100 run read 0.0211 of the
    largest logit), which would hide a wrong selection or combine."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.sharded_sparse import make_sharded_sparse_decode_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(cfg, dtype="float32")
    params = tree_map(lambda t: t.to(torch.float32), ctx["params"])
    n_shards, c = 2, CHUNK
    cap = -(-(PREFIX_LEN + 1) // (n_shards * c)) * n_shards * c
    state = T.init_serve_state(cfg, 1, cap, device=DEVICE)
    toks = torch.as_tensor(ctx["prefix"], device=DEVICE)[None]
    T.prefill(params, {"tokens": toks}, cfg, state)
    dense_state = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in state.items()}
    kc = state["k"].reshape(cfg.n_layers, 1, cap // c, c, cfg.n_kv_heads, cfg.d_head)
    state["kmean"] = kc.to(torch.float32).mean(dim=3)
    tok = torch.as_tensor([[int(ctx["suffixes"][0][0])]], device=DEVICE)
    dense, _ = T.decode_step(params, tok, cfg, dense_state)
    step = make_sharded_sparse_decode_step(
        cfg, make_serving_mesh(devices=[torch.device(DEVICE)] * n_shards), chunk_tokens=c,
        budget=1.0)
    before = da.launches
    snap = {k: state[k].clone() for k in ("k", "v", "kmean")}
    logits, new = step(params, tok, state)
    torch.cuda.synchronize()
    rel, cos = logit_agreement(logits[0, -1].float().cpu(), dense[0, -1].float().cpu())
    if not (rel <= TP_SPARSE_REL and new["length"] == PREFIX_LEN + 1
            and torch.isfinite(logits).all()):
        fail(f"tp (d): sharded sparse step max err / max |logit| {rel} > {TP_SPARSE_REL} "
             f"(length {new['length']})")
    if not torch.equal(new["k"][0, :, PREFIX_LEN], dense_state["k"][0, :, PREFIX_LEN]):
        fail("tp (d): layer 0's appended key differs from the dense step's")

    def again():
        for k in snap:
            state[k].copy_(snap[k])
        state["length"] = PREFIX_LEN
        step(params, tok, state)
    ms = wall_ms(again, reps=5)
    print(f"tp (d): make_sharded_sparse_decode_step budget 1.0 on {n_shards} shards of the card "
          f"over {PREFIX_LEN} tokens (capacity {cap}) against the dense decode_step: max abs err "
          f"/ max |logit| {rel:.4g} (tol {TP_SPARSE_REL}), cosine {cos:.6f}, argmax "
          f"{int(logits[0, -1].argmax())} vs {int(dense[0, -1].argmax())}; layer 0's appended "
          f"key bit-identical; {ms:.2f} ms a step to a synchronize (plain torch, "
          f"{da.launches - before} kernel launches; float32 weights; {smi_line})")
    del params, state, dense_state, snap
    torch.cuda.empty_cache()
    return dict(rel_err=rel, cosine=cos, wall_ms=ms, launches=da.launches - before)


def flash_held(label, q, k, v, **kw):
    """flash_attention against its plain version on the same card inputs,
    to FLASH_REL of the largest output: returns (output, err, tol)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    got, ref = flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw)
    err, tol = max_err(got, ref), FLASH_REL * ref.float().abs().max().item()
    if not err <= tol:
        fail(f"flash_attention {label}: max abs err {err} > {tol}")
    return got, err, tol


def flash_timed(q, k, v, **kw) -> dict:
    """A causal self-attention call's device, SDPA, host and plain times and
    its bound (``work_bounds``; s_q = s_k, no offset: s(s + 1) / 2 key-query
    pairs a head)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    return dict(ms=device_ms(lambda: flash_attention(q, k, v, **kw)),
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)),
                host_ms=host_ms(lambda: flash_attention(q, k, v, **kw)),
                plain_ms=wall_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=3),
                bound=work_bounds("flash_attention", **flash_shapes(q, k, **kw)))


def phase_hybrid(cfg, ctx, smi_line):
    """Compute-or-load Re-Prefill and the three-tier prefix store on the dense
    phase's weights and sessions, caches of size 0 unless named: (j) force-
    compute, (k) force-load, (l) auto (ContiguousKV, HYBRID_REQUESTS requests
    with 16 decode tokens), (m) AS-LRU force-compute on the coarse session,
    (n) ContiguousKV over a TieredPrefixStore and two tenants of one prompt,
    then serve's CLI with both flags; held as the module docstring says.
    Returns ({kernel: {path: launches}}, numbers)."""
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da,
           "flash_attention": fa, "selective_scan": ss}
    with plain_versions_counted(ops) as plain_calls:
        return _hybrid_runs(cfg, ctx, smi_line, ops, plain_calls)


def _hybrid_runs(cfg, ctx, smi_line, ops, plain_calls):
    import numpy as np
    import torch

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ASLRUEngine, ContiguousKVEngine
    from repro_torch.core.hybrid import HybridPlanner
    from repro_torch.storage.tierstore import TieredPrefixStore
    from repro_torch.storage.timing import RealExecutor

    L, V = cfg.n_layers, cfg.vocab_size
    params, sess, csess = ctx["params"], ctx["sess"], ctx["csess"]
    suffixes = ctx["suffixes"][:N_REQUESTS]
    n_periods = -(-L // PERIOD)
    plain_path = {"chunk_score": n_periods, "chunk_attention": L,
                  "decode_attention": L * DECODE_TOKENS}
    paths, numbers, walls = {}, {}, {}

    def run(label, eng, sfx, n, expect_flash=None):
        """n requests through ``eng`` (drive_serial), launches per request
        asserted (the plan's, plus expect_flash flash_attention launches,
        None: 0), no plain version; returns [(logits, trace, taps, recompute
        op host ms)]."""
        taps = _tapped(eng)
        out = []
        reset_counts(*ops.values())
        plain_calls.clear()
        for i in range(n):
            before = {k: mod.launches for k, mod in ops.items()}
            busy = eng.ex.stage_times.get("recompute", 0.0)
            t0 = time.perf_counter()
            logits, trace = eng.reprefill(sfx[i], request_id=i, decode_tokens=DECODE_TOKENS)
            walls.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
            got = {k: mod.launches - before[k] for k, mod in ops.items()}
            want = dict(plain_path if isinstance(eng, ContiguousKVEngine) else
                        {"chunk_score": 0, "chunk_attention": L,
                         "decode_attention": L * DECODE_TOKENS},
                        flash_attention=expect_flash(trace) if expect_flash else 0,
                        selective_scan=0)
            if got != want:
                fail(f"hybrid {label} request {i}: launches {got}, expected {want}")
            toks = trace.decode_tokens_out
            if (logits.shape != (1, 1, V) or not np.isfinite(logits).all()
                    or len(toks) != DECODE_TOKENS or not all(0 <= t < V for t in toks)):
                fail(f"hybrid {label} request {i}: bad output")
            out.append((logits, trace, taps[i],
                        (eng.ex.stage_times.get("recompute", 0.0) - busy) * 1e3))
        if plain_calls:
            fail(f"hybrid {label}: plain versions ran on the card: {plain_calls}")
        for k, mod in ops.items():
            if mod.launches:
                paths.setdefault(k, {})[f"hybrid {label}"] = counts(mod)
        eng.ex.shutdown()
        return out

    def checked(label, want, fn):
        """``fn()`` outside ``run``: the launches it makes are ``want``'s
        (absent kernels: 0; a callable is given the count), and no plain
        version ran."""
        before = {k: mod.launches for k, mod in ops.items()}
        plain_before = dict(plain_calls)
        out = fn()
        got = {k: mod.launches - before[k] for k, mod in ops.items()}
        bad = [k for k in ops if not (want[k](got[k]) if callable(want.get(k))
                                      else got[k] == want.get(k, 0))]
        if bad:
            fail(f"hybrid {label}: launches {got}, expected {want}")
        if plain_calls != plain_before:
            fail(f"hybrid {label}: plain versions ran on the card: {plain_calls} "
                 f"(before: {plain_before})")
        return out

    def hold(label, got, ref, exact):
        """Each request's first-token logits and decode steps against the
        reference run's: bit for bit (``exact``), else within the dense
        limits up to the first step whose input token differs."""
        worst, agree = (0.0, 1.0), 0
        for i, ((lg, tg, pg, _), (lr, tr, pr, _)) in enumerate(zip(got, ref)):
            same = (np.array_equal(pg["first"], pr["first"]) and np.array_equal(lg, lr)
                    and tg.decode_tokens_out == tr.decode_tokens_out)
            if exact and not same:
                fail(f"hybrid {label} request {i}: not bit-identical to its reference")
            pairs = [(pg["first"], pr["first"])]
            for step, (a, b) in enumerate(zip(pg["steps"], pr["steps"])):
                pairs.append((a, b))
                if tg.decode_tokens_out[step] != tr.decode_tokens_out[step]:
                    break
            for a, b in pairs:
                rel, cos = logit_agreement(a[0, -1], b[0, -1])
                worst = (max(worst[0], rel), min(worst[1], cos))
            agree += sum(x == y for x, y in zip(tg.decode_tokens_out, tr.decode_tokens_out))
        if not (worst[0] <= DENSE_REL_TOL and worst[1] >= DENSE_MIN_COS):
            fail(f"hybrid {label}: logits max err / max |logit| {worst[0]}, cosine {worst[1]}")
        n_tok = len(got) * DECODE_TOKENS
        print(f"hybrid {label}: logits against the reference, worst over first tokens and the "
              f"decode steps up to a differing token: max abs err / max |logit| {worst[0]:.4g} "
              f"(tol {DENSE_REL_TOL}), cosine {worst[1]:.6f} (min {DENSE_MIN_COS}); greedy "
              f"tokens agreeing {agree} of {n_tok}; bit-identical: "
              f"{all(np.array_equal(a[0], b[0]) for a, b in zip(got, ref))}")
        return dict(max_rel_err=worst[0], min_cos=worst[1], tokens_agreeing=agree,
                    tokens=n_tok)

    def engine(hybrid=None, cache=None):
        return ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                                  budget=BUDGET, period=PERIOD, subperiod=SUBPERIOD,
                                  cache=cache, hybrid=hybrid)

    # the reference: ContiguousKV without a planner on caches of size 0
    ref = run("reference (no planner)", engine(), suffixes, N_REQUESTS)

    def recorded(be, recs):
        """Have ``be.recompute_prefix_kv`` append its outputs and host time
        (forward and copy to the host) to ``recs``."""
        recompute = be.recompute_prefix_kv

        def timed(tokens, end, block_q):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k, v = recompute(tokens, end, block_q)  # ends with the copy to the host
            recs.append(dict(end=end, k=k, v=v, ms=(time.perf_counter() - t0) * 1e3))
            return k, v
        be.recompute_prefix_kv = timed

    # (j) force-compute, the recompute's outputs recorded beside the store
    eng = engine(HybridPlanner("force-compute"))
    recs = []
    recorded(eng.backend, recs)
    got_j = run("(j) force-compute", eng, suffixes, HYBRID_REQUESTS,
                expect_flash=lambda tr: L if tr.recompute_units else 0)
    c = sess.meta.chunk_tokens
    kv_equal = kv_total = 0
    kv_err = 0.0
    for i, (_, tr, _, op_ms) in enumerate(got_j):
        r, (_, t0, _, _) = recs[i], ref[i]
        d = tr.hybrid_decision
        if not (tr.recompute_units > 0 and r["end"] == tr.recompute_tokens
                and tr.ssd_bytes < t0.ssd_bytes):
            fail(f"hybrid (j) request {i}: recompute_units {tr.recompute_units}, end "
                 f"{r['end']}, ssd_bytes {tr.ssd_bytes} against {t0.ssd_bytes}")
        for l in range(L):
            stored = sess.store.read_units(l, list(d.recompute_units))
            for u in d.recompute_units:
                lo = u * c
                a = np.stack([r["k"][l, lo: lo + c], r["v"][l, lo: lo + c]], axis=1)
                kv_total += 1
                kv_equal += np.array_equal(a, stored[u])
                kv_err = max(kv_err, float(np.abs(a.astype(np.float32)
                                                  - stored[u].astype(np.float32)).max()))
        print(f"hybrid (j) request {i}: {tr.recompute_units} units recomputed over [0, "
              f"{tr.recompute_tokens}) ({len(d.load_units)} left to load), TTFT "
              f"{tr.ttft * 1e3:.2f} ms (no planner {t0.ttft * 1e3:.2f} ms), ssd_bytes "
              f"{tr.ssd_bytes} (no planner {t0.ssd_bytes}), ssd_bytes_avoided "
              f"{tr.ssd_bytes_avoided}; recompute op {op_ms:.2f} ms on the host, of which "
              f"recompute_prefix_kv (forward and copy to the host) {r['ms']:.2f} ms; stages ms "
              f"{ {k: round(v * 1e3, 2) for k, v in tr.stages.items()} }")
    end = recs[0]["end"]
    kv_share = kv_equal / kv_total
    print(f"hybrid (j): recomputed KV against the store, by unit and layer: {kv_equal} of "
          f"{kv_total} bit-identical ({100 * kv_share:.2f} %), max abs difference {kv_err:.4g} "
          f"(the ingest ran its GEMMs over {PREFIX_LEN} rows, the recompute over {end})")
    # the same check at frontiers below the prefix length, where the
    # recompute's GEMMs run over fewer rows than the ingest's (a record)
    shorter = {}
    be = RealCompute(cfg, params, device=DEVICE)
    for e in KV_CHECK_ENDS:
        k_e, v_e = checked(f"recompute_prefix_kv at end {e}", {"flash_attention": L},
                           lambda e=e: be.recompute_prefix_kv(sess.tokens, e,
                                                              block_q=min(512, PREFIX_LEN)))
        eq = tot = 0
        diff = 0.0
        for l in range(L):
            stored = sess.store.read_units(l, list(range(e // c)))
            for u, rec in stored.items():
                a = np.stack([k_e[l, u * c: (u + 1) * c], v_e[l, u * c: (u + 1) * c]], axis=1)
                tot += 1
                eq += np.array_equal(a, rec)
                diff = max(diff, float(np.abs(a.astype(np.float32) - rec.astype(np.float32)).max()))
        shorter[e] = dict(bit_equal=eq, units=tot, max_abs_diff=diff)
        print(f"hybrid (j): recompute_prefix_kv at end {e} against the store: {eq} of {tot} "
              f"(unit, layer) records bit-identical ({100 * eq / tot:.2f} %), max abs "
              f"difference {diff:.4g}")
    del k_e, v_e
    numbers["j"] = dict(hold(f"(j) force-compute vs no planner", got_j, ref, exact=False),
                        kv_at_shorter_ends=shorter,
                        kv_bit_equal=kv_equal, kv_units=kv_total, kv_max_abs_diff=kv_err,
                        end=end, ttft_ms=[t.ttft * 1e3 for _, t, _, _ in got_j],
                        ttft_no_planner_ms=[t.ttft * 1e3 for _, t, _, _ in ref[:HYBRID_REQUESTS]],
                        recompute_op_host_ms=[g[3] for g in got_j],
                        recompute_prefix_kv_ms=[r["ms"] for r in recs],
                        ssd_bytes=[t.ssd_bytes for _, t, _, _ in got_j],
                        ssd_bytes_no_planner=[t.ssd_bytes for _, t, _, _ in ref[:HYBRID_REQUESTS]],
                        ssd_bytes_avoided=[t.ssd_bytes_avoided for _, t, _, _ in got_j])
    del recs
    # one more force-compute request under the profiler: the device's busy
    # time and idle share with the recompute in the request
    eng = engine(HybridPlanner("force-compute"))
    ours = checked("(j) profiled request", dict(plain_path, flash_attention=L),
                   lambda: profile_request(eng, suffixes[0],
                                           statistics.mean(walls["(j) force-compute"]),
                                           tag="hybrid (j) force-compute"))
    eng.ex.shutdown()
    numbers["j"]["profiled_kernels"] = {k: list(v) for k, v in ours.items()}
    numbers["flash_at_end"] = _flash_at(cfg, end, smi_line)
    numbers["copy_to_host"] = _copy_to_host(cfg, end)

    # (k) force-load: the plan without a planner, bit for bit
    got_k = run("(k) force-load", engine(HybridPlanner("force-load")), suffixes, HYBRID_REQUESTS)
    if any(t.recompute_units for _, t, _, _ in got_k):
        fail("hybrid (k): force-load recomputed")
    hold("(k) force-load vs no planner", got_k, ref, exact=True)

    # (l) auto: the decision as it comes
    eng = engine(HybridPlanner("auto"))
    got_l = run("(l) auto", eng, suffixes, HYBRID_REQUESTS,
                expect_flash=lambda tr: L if tr.recompute_units else 0)
    decisions = []
    for i, (_, tr, _, _) in enumerate(got_l):
        d = tr.hybrid_decision
        decisions.append(dict(t_hybrid=d.t_hybrid, t_force_load=d.t_force_load,
                              t_force_compute=d.t_force_compute,
                              recompute_units=len(d.recompute_units),
                              load_units=len(d.load_units), end=d.recompute_tokens))
        print(f"hybrid (l) request {i}: HybridDecision t_hybrid {d.t_hybrid * 1e3:.4f} ms, "
              f"t_force_load {d.t_force_load * 1e3:.4f} ms, t_force_compute "
              f"{d.t_force_compute * 1e3:.4f} ms (modelled with the default DeviceModel); cut "
              f"after {len(d.recompute_units)} of {len(d.recompute_units) + len(d.load_units)} "
              f"missing units, end {d.recompute_tokens}; TTFT {tr.ttft * 1e3:.2f} ms")
    hp = eng.hybrid
    print(f"hybrid (l): io_scale {hp.io_scale:.4g} after {hp.io_observations} timed fetches "
          f"(measured over modelled IO time)")
    numbers["l"] = dict(hold("(l) auto vs no planner", got_l, ref,
                             exact=not any(t.recompute_units for _, t, _, _ in got_l)),
                        decisions=decisions, io_scale=hp.io_scale,
                        io_observations=hp.io_observations)

    # (m) AS-LRU force-compute on the coarse session: the whole prefix
    lru = [ASLRUEngine(csess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                       hybrid=h) for h in (None, HybridPlanner("force-compute"))]
    ref_m = run("(m) as_lru reference (no planner)", lru[0], suffixes, 1)
    recs_m = []
    recorded(lru[1].backend, recs_m)
    got_m = run("(m) as_lru force-compute", lru[1], suffixes, 1, expect_flash=lambda tr: L)
    tr = got_m[0][1]
    if tr.recompute_tokens != PREFIX_LEN or tr.ssd_bytes != 0:
        fail(f"hybrid (m): recompute over [0, {tr.recompute_tokens}), ssd_bytes {tr.ssd_bytes}")
    print(f"hybrid (m): as_lru recomputed {tr.recompute_units} blocks over [0, "
          f"{tr.recompute_tokens}), TTFT {tr.ttft * 1e3:.2f} ms (no planner "
          f"{ref_m[0][1].ttft * 1e3:.2f} ms), recompute op {got_m[0][3]:.2f} ms on the host, "
          f"of which recompute_prefix_kv {recs_m[0]['ms']:.2f} ms; ssd_bytes_avoided "
          f"{tr.ssd_bytes_avoided}")
    numbers["m"] = dict(hold("(m) as_lru force-compute vs no planner", got_m, ref_m,
                             exact=False), ttft_ms=tr.ttft * 1e3,
                        ttft_no_planner_ms=ref_m[0][1].ttft * 1e3, recompute_op_host_ms=got_m[0][3],
                        recompute_prefix_kv_ms=recs_m[0]["ms"])
    del recs_m

    # (n) the three-tier store: hits in every tier, drops out of the log and
    # compaction under the SSD tier's reads, the reference's bytes
    layout = sess.store.layout
    store = TieredPrefixStore(*TIER_CAPS, unit_bytes=layout.unit_bytes, payload_mode="memory",
                              unit_shape=sess.store.unit_shape)
    drops = [0]
    on_drop = store._on_drop

    def dropped(key, tier):
        drops[0] += tier == "ssd"
        on_drop(key, tier)
    store._on_drop = dropped
    got_n = run("(n) tiered store", engine(cache=store), suffixes, N_REQUESTS)
    hold("(n) tiered store vs caches of size 0", got_n, ref, exact=True)
    tiers = [(t.hits_device, t.hits_host, t.hits_ssd, t.misses) for _, t, _, _ in got_n]
    moved = store.ssd.compaction.units_read
    if not all(min(x[:3]) > 0 for x in tiers[1:]):
        fail(f"hybrid (n): hits (device, host, ssd, misses) by request {tiers}")
    if not (drops[0] > 0 and moved > 0 and store.ssd.pending_discards == 0):
        fail(f"hybrid (n): {drops[0]} units dropped out of the SSD tier, compaction moved "
             f"{moved}, {store.ssd.pending_discards} drops still waiting on a read")
    for i, (_, t, _, _) in enumerate(got_n):
        print(f"hybrid (n) request {i}: hits device {t.hits_device}, host {t.hits_host}, ssd "
              f"{t.hits_ssd}, misses {t.misses}; TTFT {t.ttft * 1e3:.2f} ms (caches of size 0 "
              f"{ref[i][1].ttft * 1e3:.2f} ms), ssd_bytes {t.ssd_bytes}")
    occ = store.tier_occupancy()
    print(f"hybrid (n): HBM:DRAM:SSD capacities {':'.join(map(str, TIER_CAPS))} units "
          f"({layout.unit_bytes} B a unit); resident {occ}; SSD-tier read amplification "
          f"{store.read_amplification():.4f}; {drops[0]} units dropped out of the SSD tier, "
          f"compaction moved {moved} units, {store.ssd.deferred_discards} drops waited on an SSD "
          f"read in flight; payload {store.payload_bytes() / 1e6:.2f} MB in host memory")
    numbers["n"] = dict(caps=list(TIER_CAPS), hits=tiers, read_amplification=store.read_amplification(),
                        ssd_drops=drops[0], compaction_moved=moved,
                        deferred_discards=store.ssd.deferred_discards,
                        ttft_ms=[t.ttft * 1e3 for _, t, _, _ in got_n])
    # two tenants of one prompt on one store: one copy of each unit
    shared = TieredPrefixStore(*SHARED_TIER_CAPS, unit_bytes=layout.unit_bytes,
                               payload_mode="memory", unit_shape=sess.store.unit_shape)
    tenants = [ContiguousKVEngine(dataclasses.replace(sess, tenant=t),
                                  RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                                  budget=BUDGET, period=PERIOD, subperiod=SUBPERIOD, cache=shared)
               for t in (1, 2)]
    tenant_path = dict(plain_path, decode_attention=0)
    l1, t1 = checked("(n) first tenant", tenant_path,
                     lambda: tenants[0].reprefill(suffixes[0], request_id=0))
    resident = len(shared.tiers["device"])  # what the first tenant's request left
    l2, t2 = checked("(n) second tenant", tenant_path,
                     lambda: tenants[1].reprefill(suffixes[0], request_id=1))
    for e in tenants:
        e.ex.shutdown()
    # the second tenant misses only units its prefetch warms up speculatively
    # and the selection then passes over, which nobody inserted
    if not (resident > 0 and t2.hits_device == resident and t2.ssd_bytes_demand == 0
            and np.array_equal(l1, l2) and shared.dedup_saved_units() == resident
            and shared.payload_bytes() == resident * layout.unit_bytes):
        fail(f"hybrid (n) two tenants: {resident} units resident after the first, the second's "
             f"device hits {t2.hits_device}, demand bytes {t2.ssd_bytes_demand}, dedup saved "
             f"{shared.dedup_saved_units()}, payload {shared.payload_bytes()} B")
    print(f"hybrid (n) two tenants of one prompt: the second tenant's first request hit all "
          f"{t2.hits_device} units the first tenant's left resident (no demand read), logits "
          f"bit-identical; dedup saved {shared.dedup_saved_units()} units, payload "
          f"{shared.payload_bytes() / 1e6:.2f} MB = one copy")
    numbers["n"]["dedup_saved_units"] = shared.dedup_saved_units()

    # serve's CLI on the card with both flags (reduced layers)
    import contextlib
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    positive = {"chunk_score": bool, "chunk_attention": bool, "decode_attention": bool,
                "flash_attention": lambda n: n >= 0}
    with contextlib.redirect_stdout(buf):
        done = checked("serve's CLI", positive, lambda: serve.main(
            ["--arch", cfg.name, "--n-layers", "2", "--requests", str(CLI_REQUESTS),
             "--concurrency", "1", "--decode-tokens", "2", "--hybrid-reprefill", "auto",
             "--cache-tiers", CLI_TIER_CAPS]))
    out = buf.getvalue()
    caps = dict(zip(("HBM", "DRAM", "SSD"), CLI_TIER_CAPS.split(":")))
    hits = sum(c.trace.hits_device + c.trace.hits_host + c.trace.hits_ssd for c in done)
    if (len(done) != CLI_REQUESTS or hits == 0
            or "tiered prefix store: " + " ".join(f"{k}={v}" for k, v in caps.items()) not in out
            or "tier store: hits" not in out
            or any(c.trace.hybrid_decision is None for c in done[:1])):
        fail(f"hybrid: serve --hybrid-reprefill auto --cache-tiers on the card ({hits} tier "
             f"hits):\n{out}")
    print(f"hybrid: serve --hybrid-reprefill auto --cache-tiers {CLI_TIER_CAPS} --concurrency 1 "
          f"on the card (2 layers): " + " | ".join(
              line for line in out.splitlines()
              if line.startswith(("tier", "ssd log", "hybrid", "concurr"))))
    return paths, numbers


def _flash_at(cfg, end, smi_line):
    """flash_attention at the recompute's shape (s_q = s_k = end, bfloat16,
    through the projections' transposed views) against its plain version,
    timed beside SDPA and its bound."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa

    gen = torch.Generator(device=DEVICE).manual_seed(3)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)

    q = rn(1, end, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = rn(1, end, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = rn(1, end, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    _, err, tol = flash_held(f"at s = {end}", q, k, v)
    r = dict(s=end, err=err, **flash_timed(q, k, v))
    print(f"hybrid: flash_attention at the recompute's s = {end} "
          f"({fa.variant_for(q.dtype, cfg.d_head)}): max abs err {err:.3g} (tol {tol:.3g}); "
          f"{r['ms']:.4f} ms on the card, scaled_dot_product_attention {r['library_ms']:.4f} ms, "
          f"plain version {r['plain_ms']:.2f} ms, {bound_text(r['bound'])}; host time per call "
          f"{r['host_ms']:.4f} ms ({smi_line})")
    r["bound_ms"] = r.pop("bound")["tensor_core"][0]
    return r


def _copy_to_host(cfg, end) -> dict:
    """The recompute's copy back: (L, end, n_kv, d) K and V, bfloat16 on the
    card, as float16 numpy arrays on the host."""
    import torch

    kv = torch.randn(2, cfg.n_layers, end, cfg.n_kv_heads, cfg.d_head, device=DEVICE,
                     dtype=torch.bfloat16)
    ms = wall_ms(lambda: kv.to(torch.float16).cpu().numpy(), reps=3)
    nb = kv.numel() * 2
    print(f"hybrid: the recompute's copy to the host of {nb / 1e6:.1f} MB of K and V (float16): "
          f"{ms:.2f} ms to a synchronize ({nb / ms / 1e6:.2f} GB/s)")
    return dict(bytes=nb, ms=ms)


def phase_state_kernels(hcfg, dcfg, fcfg):
    """flash_attention and selective_scan against their plain versions at
    the state-space path's shapes (and flash at the dense ingest's), timed;
    the scan also at falcon-mamba's prefill and with one CTA per SM."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
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
        got, err, tol = flash_held(label, q, k, v, **kw)
        print(f"kernels: flash_attention {label} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{dname(q)} ({variant}): max abs err {err:.3g} (tol {tol:.3g})")
        if label in ("hymba prefill", "dense ingest"):
            r = dict(err=err, **flash_timed(q, k, v, **kw))
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

    def scan_shapes(args, **kw):
        x, dt = args[0], args[1]
        b, s, d_in = x.shape
        return dict(b=b, s=s, d_in=d_in, n=n, itemsize=x.element_size(),
                    dt_itemsize=dt.element_size(), **kw)

    def scan_bound(args):  # bytes read and written once; one exp and ~6 float32
        return work_bounds("selective_scan", **scan_shapes(args))  # operations a (t, d, j)

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

    def step_bound(a):  # the decode step: state (and x, dt, B, C, y) moved once
        return work_bounds("selective_scan", **scan_shapes(a, h0=True))["tensor_core"]
    r = dict(err=err, ms=device_ms(lambda: selective_scan(*args)), library_ms=None,
             host_ms=host_ms(lambda: selective_scan(*args)),
             plain_ms=wall_ms(lambda: selective_scan_ref(*args), reps=2),
             decode_ms=device_ms(lambda: selective_scan(*dec, h0)),
             decode_host_ms=host_ms(lambda: selective_scan(*dec, h0)),
             decode_bound_ms=step_bound(dec)[0],
             falcon_decode_ms=device_ms(lambda: selective_scan(*fdec, fh0)),
             falcon_decode_host_ms=host_ms(lambda: selective_scan(*fdec, fh0)),
             falcon_decode_bound_ms=step_bound(fdec)[0],
             bound=scan_bound(args))
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
                               bound_ms=scan_bound(fargs)["tensor_core"][0])
    print(f"kernels: selective_scan falcon-mamba prefill (d_inner {fcfg.d_inner}): chunked "
          f"{r['falcon_prefill']['ms']:.4f} ms, {bound_text(scan_bound(fargs))}")
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
        bound = step_bound(a)
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
    from repro_torch.models.common import count_params
    from repro_torch.storage.timing import RealExecutor

    from repro_torch.kernels.flash_attention import ops as fa

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da}
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params = count_params(params)
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
    busies = []  # host ms inside the compute ops, by tag, per request
    op_seq = _record_ops(eng)  # request 0's ops, for the sim phase's (d)
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
        busies.append(busy)
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
               ckv_traces=traces, ckv_walls=walls, ckv_busy=busies, ckv_ops=op_seq)
    return totals, per_call, ctx


def _record_ops(eng):
    """Have ``eng``'s next plan record (kind, tag, phase) of each op it
    yields into the returned list; later plans are left alone."""
    seq = []
    plan = eng.plan

    def recording(*a, **kw):
        eng.plan = plan
        p = plan(*a, **kw)
        gen = p.gen

        def tapped():
            send = None
            while True:
                try:
                    op = gen.send(send)
                except StopIteration as stop:
                    return stop.value
                seq.append((type(op).__name__, op.tag, getattr(op, "phase", "")))
                send = yield op

        p.gen = tapped()
        return p

    eng.plan = recording
    return seq


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
    ctx["csess"] = csess  # the hybrid phase's AS-LRU request reads it
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
    from repro_torch.models.common import count_params
    from repro_torch.storage.timing import RealExecutor
    from repro_torch.tree import tree_map

    ops = {"flash_attention": fa, "selective_scan": ss}
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30  # earlier phases' weights
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params = count_params(params)
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
        params32 = tree_map(lambda t: t.to(torch.float32), params)
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
    dev = device_events(prof)
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
            name = kernel_name(k)
            c0, t0 = ours.get(name, (0, 0.0))
            ours[name] = (c0 + n, t0 + t / 1e3)
    copies = sum(t for k, _, t in dev if "Memcpy" in k or "Memset" in k) / 1e3
    mine = sum(t for _, t in ours.values())
    print(f"{tag}: profiled request: busy {busy_ms:.1f} ms = the port's kernels {mine:.2f} "
          f"ms + copies {copies:.2f} ms + other device ops {busy_ms - mine - copies:.2f} ms; "
          "the port's kernels (launches, ms): "
          + ", ".join(f"{k} ({c}, {t:.2f})" for k, (c, t) in sorted(ours.items())))
    return ours


# ---------------------------------------------------------------------------
# the MoE and frontend families, and head dim 256 (phases o-s)


def phase_wide_kernels(cfg, smi_line):
    """(o) The four attention kernels at head dim 256 (gemma3-4b: 8 query
    heads over 4 kv heads), each against its plain version at the main
    path's tolerances: flash_attention (bfloat16, s = PREFIX_LEN, window 0
    and the local layers' window), chunk_score over the prefix and
    chunk_attention over the budget's chunks of 16 tokens under a 64-token
    suffix (float32 queries, as past layer 0; the indexed form at b = 2
    bit for bit the gathered one), decode_attention over 16-token pages
    (bfloat16; the pools form at b = 2 bit for bit the stacked one). Each
    timed beside its plain version, its bound, scaled_dot_product_attention
    at d 256 and the wrapper's host time. Returns {kernel: numbers}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_attention.ref import (chunk_attention_indexed_ref,
                                                         chunk_attention_ref)
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.chunk_score.ref import chunk_score_ref
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref, stack_pool_buffers
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(256)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s, nq, nkv, d = SUFFIX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if d != 256:
        fail(f"wide kernels: {cfg.name} has d_head {d}, not 256")
    rows = {}

    # flash_attention: the ingest's shape, whole causal and windowed
    S = PREFIX_LEN
    q = rn(1, S, nq, d, dtype=torch.bfloat16).transpose(1, 2)
    k, v = (rn(1, S, nkv, d, dtype=torch.bfloat16).transpose(1, 2) for _ in range(2))
    pos = torch.arange(S, device=dev)
    flash = {}
    for window in (0, cfg.sliding_window):
        before = fa.launches_by_variant["wgmma"]
        got, err, tol = flash_held(f"d={d} window={window}", q, k, v, causal=True,
                                   window=window)
        if fa.launches_by_variant["wgmma"] != before + 1:
            fail("flash_attention at d 256 did not run the wgmma kernel")
        if not torch.equal(got, fa.flash_attention(q, k, v, window=window)):
            fail("flash_attention at d 256 is not reproducible bit for bit")
        mask = (pos[None, :] <= pos[:, None]) & (
            (pos[:, None] - pos[None, :] < window) if window else True)

        def sdpa(mask=mask, window=window):
            if not window:
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        flash[f"window_{window}"] = dict(
            err=err, ms=device_ms(lambda w=window: fa.flash_attention(q, k, v, window=w)),
            library_ms=device_ms(sdpa),
            host_ms=host_ms(lambda w=window: fa.flash_attention(q, k, v, window=w)),
            plain_ms=wall_ms(lambda w=window: flash_attention_ref(q, k, v, window=w), reps=3),
            bound=work_bounds("flash_attention", **flash_shapes(q, k, window=window)))
        r = flash[f"window_{window}"]
        print(f"wide (o): flash_attention d={d} s={S} window={window}: max abs err {err:.3g} "
              f"(tol {tol:.3g}), two runs bit-identical; {r['ms']:.4f} ms on the card, "
              f"scaled_dot_product_attention {r['library_ms']:.4f} ms, plain version "
              f"{r['plain_ms']:.2f} ms, host {r['host_ms']:.4f} ms, {bound_text(r['bound'])} "
              f"({smi_line})")
    rows["flash_attention"] = dict(flash["window_0"], windowed=flash[f"window_{cfg.sliding_window}"])

    # chunk_score over the prefix's keys, float32 queries
    m = -(-PREFIX_LEN // CHUNK)
    n_sel = math.ceil(BUDGET * m)
    qs, kk = rn(s, nq, d), rn(PREFIX_LEN, nkv, d, dtype=torch.float16)
    got, ref = cs.chunk_score(qs, kk, CHUNK), chunk_score_ref(qs, kk, CHUNK)
    err, tol = max_err(got, ref), 1e-5 * ref.abs().max().item() + 1e-6
    if not err <= tol or not torch.equal(got, cs.chunk_score(qs, kk, CHUNK)):
        fail(f"chunk_score d={d}: max abs err {err} > {tol}, or not reproducible")
    r = rows["chunk_score"] = dict(
        err=err, ms=device_ms(lambda: cs.chunk_score(qs, kk, CHUNK)),
        host_ms=host_ms(lambda: cs.chunk_score(qs, kk, CHUNK)),
        plain_ms=wall_ms(lambda: chunk_score_ref(qs, kk, CHUNK)),
        bound=bounds(nbytes(qs, kk) + 4 * m, 2.0 * s * nq * PREFIX_LEN * d, s * nq * PREFIX_LEN,
                     f16_split_ops=2 * 2.0 * s * nq * PREFIX_LEN * d))
    print(f"wide (o): chunk_score d={d} n={PREFIX_LEN} c={CHUNK}: max abs err {err:.3g} (tol "
          f"{tol:.3g}), two runs bit-identical; {r['ms']:.4f} ms on the card, plain version "
          f"{r['plain_ms']:.4f} ms, host {r['host_ms']:.4f} ms, {bound_text(r['bound'])} "
          f"({smi_line})")

    # chunk_attention: the budget's chunks under the suffix, gathered and indexed
    ks, vs = (rn(n_sel, CHUNK, nkv, d, dtype=torch.float16) for _ in range(2))
    kf, vf = rn(s, nkv, d), rn(s, nkv, d)
    o, ms = ca.chunk_attention(qs, ks, vs, n_sel, kf, vf)
    o2, ms2 = chunk_attention_ref(qs, ks, vs, n_sel, kf, vf)
    err = max(max_err(o, o2), max_err(ms, ms2))
    tol = 1e-5 * max(o2.abs().max().item(), ms2.abs().max().item()) + 1e-6
    again = ca.chunk_attention(qs, ks, vs, n_sel, kf, vf)
    if not (err <= tol and torch.equal(o, again[0]) and torch.equal(ms, again[1])):
        fail(f"chunk_attention d={d}: err {err} > {tol}, or not reproducible")
    r = rows["chunk_attention"] = chunk_attention_timing(qs, ks, vs, n_sel, kf, vf, o, ms, err)
    print(f"wide (o): chunk_attention d={d} {n_sel} chunks of {CHUNK} + {s} suffix tokens: max "
          f"abs err {err:.3g} (tol {tol:.3g}), two runs bit-identical; {r['ms']:.4f} ms on the "
          f"card, output-only scaled_dot_product_attention {r['sdpa_output_only_ms']:.4f} ms, "
          f"plain version {r['plain_ms']:.4f} ms, host {r['host_ms']:.4f} ms, "
          f"{bound_text(r['bound'])} ({smi_line})")
    b, pool_m = 2, 4 * n_sel
    kp, vp = (rn(pool_m, CHUNK, nkv, d, dtype=torch.float16) for _ in range(2))
    idx = torch.stack([torch.randperm(pool_m, generator=gen, device=dev)[:n_sel]
                       for _ in range(b)]).to(torch.int32)
    nv = torch.tensor([n_sel, n_sel - 9], dtype=torch.int32, device=dev)
    qb, kfb, vfb = rn(b, s, nq, d), rn(b, s, nkv, d), rn(b, s, nkv, d)
    oi, mi = ca.chunk_attention_indexed(qb, kp, vp, idx, nv, kfb, vfb)
    oi2, mi2 = chunk_attention_indexed_ref(qb, kp, vp, idx, nv, kfb, vfb)
    err_i = max(max_err(oi, oi2), max_err(mi, mi2))
    tol_i = 1e-5 * max(oi2.abs().max().item(), mi2.abs().max().item()) + 1e-6
    if not err_i <= tol_i:
        fail(f"chunk_attention_indexed d={d}: err {err_i} > {tol_i}")
    for i in range(b):
        go, gm = ca.chunk_attention(qb[i], kp[idx[i].long()], vp[idx[i].long()], int(nv[i]),
                                    kfb[i], vfb[i])
        if not (torch.equal(oi[i], go) and torch.equal(mi[i], gm)):
            fail(f"chunk_attention_indexed d={d}: member {i} differs from the gathered call")
    r["indexed_b2"] = dict(err=err_i, ms=device_ms(
        lambda: ca.chunk_attention_indexed(qb, kp, vp, idx, nv, kfb, vfb)))
    print(f"wide (o): chunk_attention_indexed d={d} b={b} over a {pool_m}-chunk pool: max abs "
          f"err {err_i:.3g} (tol {tol_i:.3g}), each member bit-identical to the gathered call; "
          f"{r['indexed_b2']['ms']:.4f} ms on the card ({smi_line})")

    # decode_attention: the last decode step's pool (resident pages, the tail)
    # with a partial last page and a pad slot; then the pools form at b = 2
    n_pages = n_sel + -(-(s + DECODE_TOKENS) // CHUNK)
    qd = rn(1, nq, d, dtype=torch.bfloat16)
    kpd, vpd = (rn(1, n_pages, CHUNK, nkv, d, dtype=torch.bfloat16) for _ in range(2))
    table = torch.cat([torch.arange(n_pages - 1, dtype=torch.int32, device=dev),
                       torch.full((1,), -1, dtype=torch.int32, device=dev)])[None]
    lens = torch.tensor([(n_pages - 2) * CHUNK + 5], dtype=torch.int32, device=dev)
    od, pmd = da.decode_attention(qd, kpd, vpd, table, lens)
    od2, pmd2 = decode_attention_ref(qd, kpd, vpd, table, lens)
    err_o, tol_o = max_err(od, od2), 2.0 ** -7 * od2.float().abs().max().item()
    err_m, tol_m = max_err(pmd, pmd2), 1e-5 * pmd2.abs().max().item() + 1e-7
    again = da.decode_attention(qd, kpd, vpd, table, lens)
    if not (err_o <= tol_o and err_m <= tol_m and torch.equal(od, again[0])
            and torch.equal(pmd, again[1]) and pmd[..., -1].abs().max().item() == 0.0):
        fail(f"decode_attention d={d}: err out {err_o} > {tol_o} or mass {err_m} > {tol_m}, "
             f"or not reproducible, or mass on the pad slot")
    r = rows["decode_attention"] = decode_attention_timing(qd, kpd, vpd, table, lens, od, pmd,
                                                            max(err_o, err_m))
    print(f"wide (o): decode_attention d={d} bfloat16 {n_pages - 1} pages of {CHUNK} + a pad "
          f"slot: max abs err out {err_o:.3g} (tol {tol_o:.3g}), mass {err_m:.3g} (tol "
          f"{tol_m:.3g}), two runs bit-identical; {r['ms']:.4f} ms on the card, output-only "
          f"scaled_dot_product_attention {r['sdpa_output_only_ms']:.4f} ms, plain version "
          f"{r['plain_ms']:.4f} ms, host {r['host_ms']:.4f} ms, {bound_text(r['bound'])} "
          f"({smi_line})")
    n2 = max(2, n_pages // 2)  # the second request's pool: its own page count
    pk = [kpd[0], rn(n2, CHUNK, nkv, d, dtype=torch.bfloat16)]
    pv = [vpd[0], rn(n2, CHUNK, nkv, d, dtype=torch.bfloat16)]
    qp = rn(2, nq, d, dtype=torch.bfloat16)
    tp = table.repeat(2, 1)
    tp[1, n2 - 1:] = -1
    lp = torch.tensor([int(lens), (n2 - 2) * CHUNK + 3], dtype=torch.int32, device=dev)
    op, pmp = da.decode_attention_pools(qp, pk, pv, tp, lp)
    ks_, vs_ = stack_pool_buffers(pk, pv)
    if not all(torch.equal(a, b_) for a, b_ in zip((op, pmp), da.decode_attention(
            qp, ks_, vs_, tp, lp))):
        fail(f"decode_attention_pools d={d}: differs from the stacked form on the stack")
    r["pools_b2_ms"] = device_ms(lambda: da.decode_attention_pools(qp, pk, pv, tp, lp))
    print(f"wide (o): decode_attention_pools d={d} b=2: bit-identical to the stacked form on "
          f"the padded stack; {r['pools_b2_ms']:.4f} ms on the card ({smi_line})")
    return rows


def _family_ingest(cfg, params, prefix, expect_variant):
    """A session of ``prefix`` (flash_attention launches asserted: one a
    layer, of ``expect_variant``) and its wall time."""
    import torch

    from repro_torch.core.session import build_real_session
    from repro_torch.kernels.flash_attention import ops as fa

    reset_counts(fa)
    t0 = time.perf_counter()
    sess = build_real_session(cfg, params, prefix, chunk_tokens=CHUNK, in_memory=True,
                              device=DEVICE)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    got = counts(fa)
    if got != {"launches": cfg.n_layers, expect_variant: cfg.n_layers}:
        fail(f"{cfg.name} ingest: flash_attention launches {got}, expected {cfg.n_layers} of "
             f"the {expect_variant} kernel")
    return sess, got, took


def _init_weights(tag, cfg):
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.common import count_params

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params = count_params(params)
    extra = (f", {cfg.n_experts} experts top {cfg.top_k} of d_ff {cfg.moe_d_ff}"
             if cfg.family == "moe" else "")
    windows = sorted({int(w) for w in cfg.window_sizes()})
    print(f"{tag}: {cfg.name} ({cfg.family}) {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads d_head {cfg.d_head} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size}{extra}, windows {windows}: {n_params / 1e9:.2f} B random "
          f"{cfg.dtype} weights in {time.perf_counter() - t0:.1f} s")
    return params


def _family_requests(tag, cfg, sess, params, suffixes, expect, smi_line):
    """N_REQUESTS ContiguousKV requests on ``sess`` with each kernel's
    launches per request asserted, read amplification 1.0, TTFT / TPOT
    printed; then one more request profiled, its device kernels held to the
    wrappers' launches. Returns (engine, {kernel: launches}, numbers)."""
    import numpy as np
    import torch

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.storage.timing import RealExecutor

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da}
    V = cfg.vocab_size
    eng = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                             budget=BUDGET, period=PERIOD, subperiod=SUBPERIOD)
    reset_counts(*ops.values())
    walls, traces = [], []
    for i, suffix in enumerate(suffixes):
        before = {k: mod.launches for k, mod in ops.items()}
        t0 = time.perf_counter()
        logits, trace = eng.reprefill(suffix, request_id=i, decode_tokens=DECODE_TOKENS)
        walls.append((time.perf_counter() - t0) * 1e3)
        traces.append(trace)
        got = {k: mod.launches - before[k] for k, mod in ops.items()}
        toks = trace.decode_tokens_out
        if got != expect:
            fail(f"{tag} request {i}: kernel launches {got}, expected {expect}")
        if trace.read_amplification != 1.0:
            fail(f"{tag} request {i}: read amplification {trace.read_amplification}")
        if (logits.shape != (1, 1, V) or not np.isfinite(logits).all()
                or len(toks) != DECODE_TOKENS or not all(0 <= t < V for t in toks)):
            fail(f"{tag} request {i}: bad output {logits.shape} {toks}")
        print(f"{tag}: request {i}: TTFT {trace.ttft * 1e3:.2f} ms, TPOT "
              f"{trace.tpot * 1e3:.3f} ms over {trace.n_decoded} tokens, read amplification "
              f"{trace.read_amplification}, {len(trace.selected_per_layer[0])} of "
              f"{sess.meta.n_chunks} chunks, launches {got} ({smi_line})")
    paths = {k: counts(mod) for k, mod in ops.items()}
    before = {k: mod.launches for k, mod in ops.items()}
    ours = profile_request(eng, suffixes[0], statistics.mean(walls[1:]), tag=tag)
    got = {k: mod.launches - before[k] for k, mod in ops.items()}
    hold_device_kernels(tag, ours, got, expect)
    print(f"{tag}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    numbers = dict(ttft_ms=[t.ttft * 1e3 for t in traces], tpot_ms=[t.tpot * 1e3 for t in traces],
                   wall_ms=walls)
    return eng, paths, numbers


def _hold_budget_one(tag, cfg, params, prefix, suffix):
    """A budget-1.0 request on a session ingested under ``cfg`` against
    ``cfg``'s dense forward over prefix + suffix (the dense limits)."""
    import numpy as np
    import torch

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.core.session import build_real_session
    from repro_torch.models import transformer as T
    from repro_torch.storage.timing import RealExecutor

    sess = build_real_session(cfg, params, prefix, chunk_tokens=CHUNK, in_memory=True,
                              device=DEVICE)
    full = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                              budget=1.0, period=PERIOD, subperiod=SUBPERIOD)
    logits, _ = full.reprefill(suffix)
    full.ex.shutdown()
    toks = torch.as_tensor(np.concatenate([prefix, suffix]), device=DEVICE)[None]
    dense = T.forward(params, {"tokens": toks}, cfg, logits_positions="last")[0, -1]
    hold_to_dense(tag, logits, dense)


def phase_moe(cfg, smi_line):
    """(p) granite-moe-3b-a800m at full width (depth as ``cfg`` has it)
    through ContiguousKVEngine:
    the dense cell's request shape, each kernel's launches per request, read
    amplification 1.0, TTFT and TPOT, a profiled request, the assignments
    the ingest dropped at capacity, and a budget-1.0 request against the
    dense forward on the config made dropless (capacity factor E / k);
    then (q) the Scheduler: SERVE_REQUESTS requests in a burst at c = 4
    with batched decode and part B in chunks of SERVE_PREFILL_CHUNK, and 2
    of them at c = 1 bit for bit the engine's serial run. Returns
    ({kernel: {path: launches}}, numbers)."""
    import numpy as np

    from repro_torch.models import moe as PM

    params = _init_weights("moe (p)", cfg)
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    PM.drop_log = []
    try:
        sess, ingest, took = _family_ingest(cfg, params, prefix, "wgmma")
        by_layer = [int(t) for t in PM.drop_log]
        dropped = sum(by_layer)
    finally:
        PM.drop_log = None
    assigned = cfg.n_layers * PREFIX_LEN * cfg.top_k
    cap = PM.capacity(PREFIX_LEN, cfg.n_experts, cfg.top_k, cfg.moe_capacity_factor, False)
    print(f"moe (p): ingest of {PREFIX_LEN} tokens took {took:.2f} s (flash_attention launches "
          f"{ingest}); at capacity factor {cfg.moe_capacity_factor} ({cap} slots an expert) it "
          f"dropped {dropped} of {assigned} expert assignments ({100 * dropped / assigned:.2f} "
          f"%) over {cfg.n_layers} layers; by layer (of {PREFIX_LEN * cfg.top_k} each) "
          f"{by_layer}")
    suffixes = [rng.integers(0, cfg.vocab_size, SUFFIX_LEN) for _ in range(N_REQUESTS)]
    expect = {"chunk_score": -(-cfg.n_layers // PERIOD), "chunk_attention": cfg.n_layers,
              "decode_attention": cfg.n_layers * DECODE_TOKENS}
    eng, req_paths, numbers = _family_requests("moe (p)", cfg, sess, params, suffixes, expect,
                                               smi_line)
    eng.ex.shutdown()
    dcfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.n_experts / cfg.top_k)
    _hold_budget_one(f"moe (p): budget 1.0 at capacity factor {dcfg.moe_capacity_factor}",
                     dcfg, params, prefix, suffixes[0])
    paths = {k: {f"granite-moe-3b-a800m ({cfg.n_layers} layers) requests": c}
             for k, c in req_paths.items()}
    paths["flash_attention"] = {"granite-moe-3b-a800m ingest": ingest}
    numbers.update(dropped=dropped, assignments=assigned, dropped_by_layer=by_layer)
    serve_paths, numbers["serve"] = _moe_serve(cfg, params, sess, smi_line)
    for k, by in serve_paths.items():
        paths.setdefault(k, {}).update(by)
    return paths, numbers


def _moe_serve(cfg, params, sess, smi_line):
    """(q): the burst at c = 4 and the c = 1 hold (phase_moe's docstring)."""
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da,
           "flash_attention": fa}
    with plain_versions_counted(ops) as plain_calls:
        return _moe_serve_runs(cfg, params, sess, smi_line, ops, plain_calls)


def _moe_serve_runs(cfg, params, sess, smi_line, ops, plain_calls):
    import numpy as np
    import torch

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.serving import Request, Scheduler, summarize
    from repro_torch.storage.timing import RealExecutor

    L, V = cfg.n_layers, cfg.vocab_size
    rng = np.random.default_rng(12)
    suffixes = [rng.integers(0, V, SUFFIX_LEN) for _ in range(MOE_SERVE_REQUESTS)]

    def engine(chunk=None):
        return ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                                  budget=BUDGET, period=PERIOD, subperiod=SUBPERIOD,
                                  prefill_chunk_tokens=chunk)

    eng = engine()
    refs = [eng.reprefill(suffixes[i], request_id=i, decode_tokens=DECODE_TOKENS)
            for i in range(2)]
    eng.ex.shutdown()

    def run(label, max_c, n, chunk):
        eng = engine(chunk)
        sched = Scheduler(eng, policy="fcfs", max_concurrency=max_c, batch_decode=True)
        reqs = [Request(request_id=i, suffix=suffixes[i], decode_tokens=DECODE_TOKENS)
                for i in range(n)]
        reset_counts(*ops.values())
        plain_calls.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.ex.shutdown()
        got = {k: counts(mod) for k, mod in ops.items()}
        if [c.request.request_id for c in done] != list(range(n)):
            fail(f"moe serve {label}: {len(done)} of {n} requests completed")
        for c in done:
            toks = c.trace.decode_tokens_out
            if (c.result.shape != (1, 1, V) or not np.isfinite(c.result).all()
                    or len(toks) != DECODE_TOKENS or not all(0 <= t < V for t in toks)):
                fail(f"moe serve {label} request {c.request.request_id}: bad output")
        if plain_calls:
            fail(f"moe serve {label}: plain versions ran on the card: {plain_calls}")
        s = summarize(done)
        s.update(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"moe serve {label}: {n} requests, p50 TTFT {s['p50_ttft'] * 1e3:.2f} ms, p95 "
              f"TTFT {s['p95_ttft'] * 1e3:.2f} ms, mean TPOT {s['mean_tpot'] * 1e3:.3f} ms, p95 "
              f"ITL {s['p95_itl'] * 1e3:.3f} ms, {s['decode_tok_rate']:.2f} decode tokens/s, "
              f"makespan {s['makespan']:.3f} s, peak device memory {s['peak_gib']:.2f} GiB, "
              f"launches {got} ({smi_line})")
        return done, sched, got, s

    n = MOE_SERVE_REQUESTS
    for attempt in range(1, SERVE_BATCH_TRIES + 1):  # as serve (a)'s runs
        done, sched, got, s = run("(q) c=4 batched, part B in chunks", 4, n, SERVE_PREFILL_CHUNK)
        dec = [m for m in sched.real_batch_log if m[0][1] == "decode"]
        pre = [m for m in sched.real_batch_log if m[0][1] == "prefill"]
        if dec or attempt == SERVE_BATCH_TRIES:
            break
        print(f"moe serve (q): run {attempt} of at most {SERVE_BATCH_TRIES} formed no batched "
              f"decode iteration; run again")
    if not dec or min(len(m) for m in dec) < 2:
        fail(f"moe serve (q): batched decode iterations {[len(m) for m in dec]} in run "
             f"{attempt}")
    want = {"pools": len(dec) * L, "stacked": (n * DECODE_TOKENS - sum(map(len, dec))) * L,
            "indexed": len(pre), "gathered": L * n - sum(map(len, pre))}
    have = {k: got["decode_attention" if k in ("pools", "stacked") else "chunk_attention"]
            .get(k, 0) for k in want}
    if have != want:
        fail(f"moe serve (q): launches by form {have}, expected {want}")
    print(f"moe serve (q): {len(dec)} batched decode iterations (mean b "
          f"{np.mean([len(m) for m in dec]):.2f}), {len(pre)} prefill-chunk batches; launches "
          f"by form {have}; no plain version")
    paths = {}
    for k, c in got.items():
        if c["launches"]:
            paths.setdefault(k, {})["granite-moe-3b-a800m serve (q) c=4"] = c
    done1, sched1, got1, s1 = run("(q) c=1", 1, 2, None)
    if sched1.real_batch_log:
        fail("moe serve (q) c=1: a batch formed")
    for i, (c, (logits, trace)) in enumerate(zip(done1, refs)):
        if not (np.array_equal(c.result, logits)
                and c.trace.decode_tokens_out == trace.decode_tokens_out):
            fail(f"moe serve (q) c=1 request {i}: differs from the engine's serial run")
    for k, c in got1.items():
        if c["launches"]:
            paths.setdefault(k, {})["granite-moe-3b-a800m serve (q) c=1"] = c
    print("moe serve (q) c=1: logits and greedy tokens of both requests bit-identical to the "
          "engine's serial run (the MoE combine is deterministic)")
    keys = ("p50_ttft", "p95_ttft", "mean_tpot", "p95_itl", "decode_tok_rate", "makespan",
            "peak_gib")
    return paths, {"c4": {k: s[k] for k in keys}, "c1": {k: s1[k] for k in keys},
                   "decode_batches": len(dec), "prefill_batches": len(pre)}


def phase_swa(cfg, smi_line):
    """(r) gemma3-4b at full width through ContiguousKVEngine: its 5:1 local
    (SWA-1024) and global layers ingested through flash_attention's d 256
    kernel (launches asserted, windows included), the dense cell's requests
    with every kernel's launches at d 256 asserted, TTFT / TPOT, a profiled
    request; the budget-1.0 agreement on the config without its window (the
    reference's Re-Prefill and tail decode take no window). Returns
    ({kernel: {path: launches}}, numbers)."""
    import numpy as np

    params = _init_weights("swa (r)", cfg)
    rng = np.random.default_rng(13)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    sess, ingest, took = _family_ingest(cfg, params, prefix, "wgmma")
    n_local = int((cfg.window_sizes() > 0).sum())
    print(f"swa (r): ingest of {PREFIX_LEN} tokens took {took:.2f} s (flash_attention launches "
          f"at d {cfg.d_head} {ingest}: {n_local} local layers with window "
          f"{cfg.sliding_window}, {cfg.n_layers - n_local} global)")
    suffixes = [rng.integers(0, cfg.vocab_size, SUFFIX_LEN) for _ in range(N_REQUESTS)]
    expect = {"chunk_score": -(-cfg.n_layers // PERIOD), "chunk_attention": cfg.n_layers,
              "decode_attention": cfg.n_layers * DECODE_TOKENS}
    eng, req_paths, numbers = _family_requests("swa (r)", cfg, sess, params, suffixes, expect,
                                               smi_line)
    eng.ex.shutdown()
    del eng, sess
    _hold_budget_one("swa (r): budget 1.0 without the sliding window",
                     dataclasses.replace(cfg, sliding_window=None), params, prefix, suffixes[0])
    paths = {k: {"gemma3-4b requests (d 256)": c} for k, c in req_paths.items()}
    paths["flash_attention"] = {"gemma3-4b ingest (d 256)": ingest}
    return paths, numbers


def phase_audio(cfg, smi_line):
    """(s) musicgen-large at full width on the embeds path: ``prefill`` over
    AUDIO_FRAMES frame embeddings (flash_attention at d 64, n_q = n_kv, one
    launch a layer asserted), then AUDIO_DECODE ``decode_step``s on embeds,
    each step's logits held against ``forward`` over the same embeds (the
    dense limits). Returns ({kernel: {path: launches}}, numbers)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import make_frontend_embeds

    params = _init_weights("audio (s)", cfg)
    F_, D_ = AUDIO_FRAMES, AUDIO_DECODE
    e = make_frontend_embeds(cfg, 1, F_ + D_, torch.Generator(device=DEVICE).manual_seed(14),
                             DEVICE)
    state = T.init_serve_state(cfg, 1, F_ + D_, device=DEVICE)
    reset_counts(fa)
    t0 = time.perf_counter()
    first, state = T.prefill(params, {"embeds": e[:, :F_]}, cfg, state)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    got = counts(fa)
    if got != {"launches": cfg.n_layers, "wgmma": cfg.n_layers}:
        fail(f"audio (s): prefill flash_attention launches {got}, expected {cfg.n_layers} of "
             f"the wgmma kernel")
    steps, step_ms = [], []
    for i in range(D_):
        t0 = time.perf_counter()
        logits, state = T.decode_step(params, e[:, F_ + i: F_ + i + 1], cfg, state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(logits[0, -1])
    full = T.forward(params, {"embeds": e}, cfg)[0]
    worst = (0.0, 1.0)
    for i, a in enumerate([first[0, -1]] + steps[:-1]):
        rel, cos = logit_agreement(a, full[F_ - 1 + i])
        worst = (max(worst[0], rel), min(worst[1], cos))
    rel, cos = logit_agreement(steps[-1], full[-1])  # the last step's own next frame
    worst = (max(worst[0], rel), min(worst[1], cos))
    if not (worst[0] <= DENSE_REL_TOL and worst[1] >= DENSE_MIN_COS
            and torch.isfinite(torch.stack(steps)).all()):
        fail(f"audio (s): prefill / decode logits against forward: max err / max |logit| "
             f"{worst[0]}, cosine {worst[1]}")
    print(f"audio (s): prefill of {F_} frame embeddings {prefill_ms:.2f} ms (flash_attention "
          f"launches {got}), {D_} decode steps on embeds, mean {statistics.mean(step_ms):.3f} ms "
          f"a step; prefill and every step against forward over the same embeds, worst: max "
          f"abs err / max |logit| {worst[0]:.4f} (tol {DENSE_REL_TOL}), cosine {worst[1]:.5f} "
          f"(min {DENSE_MIN_COS}) ({smi_line})")
    return ({"flash_attention": {"musicgen-large prefill": got}},
            dict(prefill_ms=prefill_ms, step_ms=step_ms, rel=worst[0], cos=worst[1]))


def free_weights():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training: qwen3-1.7b at full width (phase t)


def _visible_pairs(s: int, window: int) -> int:
    """Key-query pairs of causal self-attention over s positions, the window
    (if any) included."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _sdpa_bwd(q, k, v, do, window):
    """A function timing the backward of one scaled_dot_product_attention
    call on the same inputs (the window as a boolean mask): the yardstick."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    s = q.shape[2]
    if window > 0:
        pos = torch.arange(s, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def _sdpa_bwd_ms(q, k, v, do, window):
    """(device ms of SDPA's backward on these inputs, None) or, where no
    backend takes them, (None, its message)."""
    try:
        return device_ms(_sdpa_bwd(q, k, v, do, window), reps=10), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


def phase_train_kernel(cfg, smi_line):
    """(t1) flash_attention's backward kernel against its plain version at
    the training step's shape (bfloat16, causal), with sliding window 1024,
    at gemma3-4b's (8 / 4 heads of 256, causal and window 1024: the wgmma
    variant's d 256 kernels), at hymba-1.5b's (25 / 5 heads of 64, causal)
    and in float32 at the tiny preset's d 16 (the forward's output, which the backward reads,
    first held to its plain version; where the backward's variant reads a
    logsumexp, the forward run again with its lse output, the same bits, and
    that lse held to its plain version): each gradient's error and two runs
    bit for bit, the variant that ran, timed beside its bound (the
    function's five products; the products the variant runs as
    ``design_bound``), SDPA's backward (or the backend's refusal), the plain
    version and the wrapper's host time. First the registers and spill bytes
    of the d 256 kernels, the backward's and both of the forward's (with and
    without the lse; ptxas -v). Returns {label: numbers}, with those
    kernels' under "d256_ptxas"."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_lse_ref)

    ptx = ptxas_info("wgmma256")
    for name, (regs, st_b, ld_b) in sorted(ptx.items()):
        print(f"train (t1): {name} (ptxas -v, {B_LOG}): {regs} registers, {st_b} / {ld_b} bytes "
              f"of spill stores / loads")
    gen = torch.Generator(device=DEVICE).manual_seed(23)

    def rn(shape, dtype):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    s, nq, nkv, d = TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bf = torch.bfloat16
    shapes = (("main", bf, s, nq, nkv, d, 0),
              ("window_1024", bf, s, nq, nkv, d, BWD_WINDOW),
              ("gemma_d256", bf, s, *SWA_HEADS, 0),
              ("gemma_d256_window_1024", bf, s, *SWA_HEADS, BWD_WINDOW),
              ("hymba_d64", bf, s, *SSM_HEADS, 0),
              ("float32_tiny", torch.float32, 128, 4, 2, 16, 0))
    out_rows = {"d256_ptxas": {k: dict(zip(("registers", "spill_store_bytes",
                                            "spill_load_bytes"), v))
                               for k, v in ptx.items()}}
    for label, dtype, s_, nq_, nkv_, d_, window in shapes:
        # the model's (b, s, n, d) projections, read through transposed views
        q = rn((1, s_, nq_, d_), dtype).transpose(1, 2)
        k = rn((1, s_, nkv_, d_), dtype).transpose(1, 2)
        v = rn((1, s_, nkv_, d_), dtype).transpose(1, 2)
        do = rn((1, s_, nq_, d_), dtype).transpose(1, 2)
        variant = fa.bwd_variant_for(dtype, d_)
        with torch.no_grad():  # the forward at this shape, held to its plain version
            out, f_err, f_tol = flash_held(f"train (t1) {label}", q, k, v, window=window)
            lse, lse_err = None, None
            if fa.writes_lse(dtype, d_):  # the same forward writing the lse the backward reads
                lse = fa.lse_buffer(q)
                again = fa.flash_attention(q, k, v, window=window, lse=lse)
                lse_err = max_err(lse[..., :s_], flash_attention_lse_ref(q, k, window=window))
                if not torch.equal(again, out) or not lse_err <= LSE_TOL:
                    fail(f"flash_attention {label}: the output with lse the same bits: "
                         f"{torch.equal(again, out)}; lse max abs err {lse_err} > {LSE_TOL}")
                del again
        args, kw = (q, k, v, out, do), dict(window=window, lse=lse)
        before = dict(fa.bwd_launches_by_variant)
        got = fa.flash_attention_bwd(*args, **kw)
        ran = [v_ for v_, n in fa.bwd_launches_by_variant.items() if n != before[v_]]
        if ran != [variant]:
            fail(f"flash_attention_bwd {label}: ran {ran}, expected {variant}")
        same = all(torch.equal(a, b) for a, b in zip(got, fa.flash_attention_bwd(*args, **kw)))
        want = flash_attention_bwd_ref(*args, window=window)
        rel = BWD_F32_REL if dtype == torch.float32 else FLASH_REL
        errs = {n: max_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        tols = {n: rel * w.float().abs().max().item() for n, w in zip(("dq", "dk", "dv"), want)}
        if not same or any(errs[n] > tols[n] for n in errs):
            fail(f"flash_attention_bwd {label}: errors {errs} (tolerances {tols}), two runs "
                 f"bit-identical: {same}")
        pairs = _visible_pairs(s_, window)
        shapes = flash_shapes(q, k, window=window)

        def work_bound(work):  # the products and exponentials a design runs, the bytes moved
            from repro_torch.kernels.work import kernel_work

            moved = kernel_work("flash_attention_bwd", **shapes).bytes
            return bounds(moved, work[0] * 2.0 * pairs * d_ * nq_, work[1] * nq_ * pairs)

        n_prod = BWD_DESIGN_WORK[variant][0]
        library_ms, refused = _sdpa_bwd_ms(q, k, v, do, window)
        r = dict(err=max(errs.values()), errs=errs, tols=tols, bit_identical=same,
                 forward_err=f_err, lse_err=lse_err, variant=variant, products=n_prod,
                 ms=device_ms(lambda: fa.flash_attention_bwd(*args, **kw), reps=10),
                 library_ms=library_ms, library_refused=refused,
                 host_ms=host_ms(lambda: fa.flash_attention_bwd(*args, **kw), reps=10),
                 plain_ms=wall_ms(lambda: flash_attention_bwd_ref(*args, window=window), reps=3),
                 bound=work_bounds("flash_attention_bwd", **shapes),
                 design_bound=work_bound(BWD_DESIGN_WORK[variant]))
        lse_text = "" if lse_err is None else f"; its lse max abs err {lse_err:.3g} (tol {LSE_TOL})"
        sdpa_text = (f"SDPA's backward {library_ms:.4f} ms" if refused is None
                     else f"SDPA's backward refused ({refused})")
        print(f"train (t1): flash_attention_bwd {label} ({dname(q)}, 1 x {nq_}/{nkv_} heads, "
              f"s {s_}, d {d_}, window {window}, variant {variant}): the forward's output max abs "
              f"err {f_err:.3g} (tol {f_tol:.3g}){lse_text}; max abs err dq {errs['dq']:.3g} dk "
              f"{errs['dk']:.3g} dv {errs['dv']:.3g} (tol {tols['dq']:.3g}, {tols['dk']:.3g}, "
              f"{tols['dv']:.3g}), two runs bit-identical; {r['ms']:.4f} ms on the card, "
              f"{sdpa_text}, plain version {r['plain_ms']:.2f} ms, "
              f"{bound_text(r['bound'])} ({BWD_WORK[0]} products); the {n_prod} products "
              f"{variant} runs: {r['design_bound']['tensor_core'][0]:.5f} ms; host time per call "
              f"{r['host_ms']:.4f} ms ({smi_line})")
        out_rows[label] = r
        del q, k, v, do, out, got, want, args, kw, lse
        free_weights()
    return out_rows


@contextlib.contextmanager
def plain_attention():
    """The model's prefill attention as the block-wise plain torch form (the
    CPU path's), on the card: autograd differentiates it as it is."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import attention_prefill_blockwise

    saved = T.attention_prefill
    T.attention_prefill = lambda q, k, v, *, window=0, block_q=512: attention_prefill_blockwise(
        q, k, v, window=window, block_q=block_q)
    try:
        yield
    finally:
        T.attention_prefill = saved


def _train_batch(cfg, b, s, seed):
    """Next-token pairs of b rows of s + 1 numpy-seeded tokens, on the card;
    for a frontend family (musicgen's EnCodec frames) numpy-seeded frame
    embeddings (b, s, d_model) in place of the tokens, with labels below
    its vocab."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"labels": torch.as_tensor(seq[:, 1:], device=DEVICE)}
    if cfg.frontend:
        embeds = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
        batch["embeds"] = torch.as_tensor(embeds, device=DEVICE).to(cfg.activation_dtype())
    else:
        batch["tokens"] = torch.as_tensor(seq[:, :-1], device=DEVICE)
    return batch


def _train_flops(cfg, params, b: int, s: int):
    """(model FLOPs of one training step, what they count): 6 N T for the N
    parameters that multiply (all but the input embedding's gather; of an
    MoE's expert weights the top_k / n_experts share each token runs) over
    T = b s tokens, plus the attention products: forward 2 x 2 x pairs x d x
    n_q a layer and sequence, each layer's pairs under its own window,
    backward twice that."""
    from repro_torch.models.common import count_params

    n = count_params(params) - params["embed"].numel()
    what = f"6 x {n / 1e9:.3f} B params"
    if cfg.family == "moe":
        experts = sum(params["layers"]["moe"][k].numel() for k in ("w_gate", "w_up", "w_down"))
        n -= experts * (1 - cfg.top_k / cfg.n_experts)
        what = f"6 x {n / 1e9:.3f} B active params ({cfg.top_k} of {cfg.n_experts} experts)"
    windows = [int(w) for w in cfg.window_sizes()] if cfg.has_attention else []
    pairs = sum(_visible_pairs(s, w) for w in windows)
    what += f" x {b * s} tokens"
    if windows:
        what += " + attention" + (f" (each layer's window: {sorted(set(windows))})"
                                  if any(windows) else "")
    return 6.0 * n * b * s + 3 * 4.0 * pairs * cfg.d_head * cfg.n_heads * b, what


def _flash_train_counts():
    """The flash wrappers' counts: forward and backward, total and by variant."""
    from repro_torch.kernels.flash_attention import ops as fa

    return {"flash forward": fa.launches, "flash backward": fa.bwd_launches,
            **{f"flash forward {k}": n for k, n in fa.launches_by_variant.items()},
            **{f"flash backward {k}": n for k, n in fa.bwd_launches_by_variant.items()}}


def phase_train_family(cfg, steps: int, tag: str, smi_line, keep_params: bool = False):
    """make_train_step(grad_accum=2, remat=False, lr=3e-4) on an attention
    model at full width (seeded bfloat16 weights; depth as ``cfg`` has it)
    over (t2)'s fixed batch of 2 x 4096 numpy-seeded tokens (frame embeddings
    for musicgen) for ``steps`` steps: the loss falls; each step's flash
    forward and backward launches (2 x layers each, every one of the
    variants its dtype and head dim pick) and no plain version asserted;
    step time, tokens/s, model-FLOPs utilisation (``_train_flops``, its
    count printed), peak memory; one more step profiled (the flash backward
    kernels' share of its device time, each by name, and the idle share).
    Returns (params if ``keep_params`` else None, {kernel: launches},
    numbers)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import param_bytes
    from repro_torch.train.optimizer import adamw_init

    params = _init_weights(tag, cfg)
    opt = adamw_init(params)
    print(f"{tag}: params {param_bytes(params) / 1e9:.2f} GB, AdamW moments "
          f"{param_bytes({'m': opt['m'], 'v': opt['v']}) / 1e9:.2f} GB")
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 23)
    step = make_train_step(cfg, grad_accum=TRAIN_ACCUM, remat=False, lr=TRAIN_LR)
    per = TRAIN_ACCUM * cfg.n_layers
    dtype = cfg.activation_dtype()
    expect = {"flash forward": per, "flash backward": per,
              f"flash forward {fa.variant_for(dtype, cfg.d_head)}": per,
              f"flash backward {fa.bwd_variant_for(dtype, cfg.d_head)}": per}
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    fa.bwd_launches = fa.dout_copies = 0
    fa.bwd_launches_by_variant = dict.fromkeys(fa.bwd_launches_by_variant, 0)
    losses, step_ms = [], []
    with plain_versions_counted({"flash_attention": fa}) as plain_calls:
        for i in range(steps):
            before = _flash_train_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: n - before[k] for k, n in _flash_train_counts().items() if n != before[k]}
            if got != expect or plain_calls or not math.isfinite(losses[-1]):
                fail(f"{tag} step {i}: loss {losses[-1]}, launches {got}, expected {expect}; "
                     f"plain versions {plain_calls}")
            print(f"{tag}: step {i}: loss {losses[-1]:.4f}, {step_ms[-1]:.1f} ms, launches "
                  f"{got} ({smi_line})")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall over {steps} steps: {losses}")
    launches = {"flash_attention": counts(fa),
                "flash_attention_bwd": {"launches": fa.bwd_launches,
                                        **{k: n for k, n in fa.bwd_launches_by_variant.items()
                                           if n}}}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm = statistics.median(step_ms[1:])
    flops, what = _train_flops(cfg, params, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / (warm / 1e3) / TENSOR_CORE_OPS_PER_S
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag}: {cfg.name} at {cfg.n_layers} layers: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {steps} steps; warm step {warm:.1f} ms (median of steps "
          f"1-{steps - 1}), {tokens / warm * 1e3:,.0f} tokens/s; {flops / 1e12:.1f} TFLOP a "
          f"step ({what}), model-FLOPs utilisation {100 * mfu:.1f} % of 989 TFLOP/s; peak "
          f"device memory {peak:.1f} GiB; dout copies {fa.dout_copies} ({smi_line})")
    params, opt, prof = profile_train_step(step, params, opt, batch, warm, tag=tag)
    del opt, metrics
    if not keep_params:
        params = None
    free_weights()
    numbers = dict(layers=cfg.n_layers, losses=losses, step_ms=step_ms, warm_step_ms=warm,
                   tokens_per_s=tokens / warm * 1e3, mfu=mfu, mfu_counts=what, peak_gib=peak,
                   dout_copies=fa.dout_copies, **prof)
    return params, launches, numbers


def phase_train_step(cfg, smi_line):
    """(t2) phase_train_family on full-width qwen3-1.7b (28 layers) for
    TRAIN_STEPS steps: 2 x 28 flash forward and backward launches a step,
    both wgmma. Returns (params, {path: launches}, numbers)."""
    return phase_train_family(cfg, TRAIN_STEPS, "train (t2)", smi_line, keep_params=True)


def phase_train_roofline(cfg, params, warm_ms: float, smi_line):
    """(t17) The dry run's count held against a live step: (t2)'s step
    (``make_train_step(grad_accum=2, remat=False)`` on full-width qwen3-1.7b
    over (t2)'s 2 x 4096 tokens, bfloat16, the weights (t2) trained) counted
    under ``StepAnalyzer`` once on the card, its flash kernels launching,
    and once on meta tensors of the same shapes, whose wrappers' meta routes
    launch nothing: the aten products, each kernel's ``kernel_work`` totals
    and the launches the wrappers report to the analyzer (56 flash forward,
    56 backward) must be equal, the wrappers' own counters must show the 56
    + 56 live launches and none on meta. Printed
    beside the card's name and power limit: the predicted bytes (the step's
    arguments plus the meta count's peak live bytes) against
    ``torch.cuda.max_memory_allocated`` over the live step, the roofline
    time against (t2)'s warm step and that share, and the dominant term;
    then the row of ``python -m repro_torch.launch.dryrun`` on qwen3-1.7b's
    train_4k cell over the single-pod mesh, run in a process of its own
    beside the counts. The step's outputs are dropped:
    (u) serves (t2)'s weights. Returns ({kernel: {path: launches}},
    numbers)."""
    t_phase = time.perf_counter()
    # the dry run's CLI counts on the host's CPU while this process counts
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cfg.name, "--shape",
           "train_4k", "--mesh", "single"]
    cli = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        paths, numbers = _train_roofline_counts(cfg, params, warm_ms, smi_line)
        out, err = cli.communicate(timeout=300)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    cli_s = time.perf_counter() - t_phase
    if cli.returncode != 0:
        fail(f"train (t17): the dry run exited {cli.returncode}: {err[-2000:]}")
    row = [ln for ln in out.splitlines() if ln.startswith(cfg.name)]
    print(f"train (t17): python -m repro_torch.launch.dryrun --arch {cfg.name} --shape train_4k "
          f"--mesh single (done {cli_s:.1f} s after the phase began): "
          f"{row[0] if row else out[-500:]}")
    numbers.update(dryrun_cli_s=cli_s, dryrun_row=row[0] if row else None,
                   seconds=time.perf_counter() - t_phase)
    return paths, numbers


def _train_roofline_counts(cfg, params, warm_ms: float, smi_line):
    """(t17)'s two counts of (t2)'s step and what they predict (see
    ``phase_train_roofline``)."""
    import torch

    from repro_torch.launch import roofline as RL
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 23)
    step = make_train_step(cfg, grad_accum=TRAIN_ACCUM, remat=False, lr=TRAIN_LR)
    opt = adamw_init(params)
    arg_bytes = sum(nbytes(t) for t in tree_leaves((params, opt, batch)))

    def count(args):  # the analyzer and the launches the wrappers counted
        before = _flash_train_counts()
        with RL.StepAnalyzer() as a:
            out = step(*args)
        del out
        got = {k: n - before[k] for k, n in _flash_train_counts().items() if n != before[k]}
        return a, got

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    live, live_launches = count((params, opt, batch))
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    def meta(t):
        return torch.empty_like(t, device="meta")

    # the meta routes launch nothing: they report to the analyzer alone
    t0 = time.perf_counter()
    dry, dry_launches = count((tree_map(meta, params), tree_map(meta, opt), tree_map(meta, batch)))
    meta_s = time.perf_counter() - t0
    del opt
    free_weights()
    per = TRAIN_ACCUM * cfg.n_layers
    flash = {"flash forward": per, "flash backward": per, "flash forward wgmma": per,
             "flash backward wgmma": per}
    reported = {("flash_attention", "wgmma"): per, ("flash_attention_bwd", "wgmma"): per}
    if (live.aten_flops != dry.aten_flops or live.kernels != dry.kernels
            or live.launches != dry.launches or live.launches != reported
            or live_launches != flash or dry_launches):
        fail(f"train (t17): the live and the meta count differ: aten products "
             f"{live.aten_flops} / {dry.aten_flops}, kernels {live.kernels} / {dry.kernels}, "
             f"launches reported {live.launches} / {dry.launches} (expected {reported}), "
             f"launched {live_launches} / {dry_launches} (expected {flash} / none)")
    model_flops, _ = _train_flops(cfg, params, TRAIN_BATCH, TRAIN_SEQ)
    predicted = arg_bytes + dry.peak_bytes
    rep = RL.roofline(dry.metrics, arch=cfg.name, shape="train (t2)", mesh="one card",
                      model_flops_per_device=model_flops, bytes_per_device=predicted)
    t_roof = max(rep.t_compute, rep.t_memory, rep.t_collective)
    share = t_roof / (warm_ms / 1e3)
    kern = {k: {n: v[n] for n in ("calls", "products", "bytes", "exponentials")}
            for k, v in dry.kernels.items()}
    print(f"train (t17): (t2)'s step counted live ({live_s:.1f} s) and on meta ({meta_s:.1f} s): "
          f"aten products {live.aten_flops:.6e} both, kernel work equal ({kern}), launches "
          f"reported {dict(live.launches)} both, launched {live_launches} live and none on meta "
          f"({smi_line})")
    print(f"train (t17): predicted bytes {predicted / 2**30:.2f} GiB (arguments "
          f"{arg_bytes / 2**30:.2f} + the meta count's peak live {dry.peak_bytes / 2**30:.2f}) "
          f"against max_memory_allocated {peak / 2**30:.2f} GiB over the live step (allocated "
          f"before it {base / 2**30:.2f}; the live count's peak live {live.peak_bytes / 2**30:.2f}); "
          f"roofline {t_roof * 1e3:.1f} ms (compute {rep.t_compute * 1e3:.1f}, memory "
          f"{rep.t_memory * 1e3:.1f}, every-op memory {rep.t_memory_upper * 1e3:.1f}) against "
          f"(t2)'s warm step {warm_ms:.1f} ms: {100 * share:.1f} %, dominant {rep.dominant}; "
          f"useful {rep.useful_ratio:.3f} ({smi_line})")
    numbers = dict(aten_flops=dry.aten_flops, kernels=kern, launches=live_launches,
                   predicted_bytes=predicted, arg_bytes=arg_bytes, meta_peak_bytes=dry.peak_bytes,
                   live_peak_bytes=live.peak_bytes, max_memory_allocated=peak,
                   allocated_before=base, roofline_ms=t_roof * 1e3, t_compute_ms=rep.t_compute * 1e3,
                   t_memory_ms=rep.t_memory * 1e3, t_memory_upper_ms=rep.t_memory_upper * 1e3,
                   warm_step_ms=warm_ms, roofline_share=share, dominant=rep.dominant,
                   live_count_s=live_s, meta_count_s=meta_s)
    paths = {"flash_attention": {"qwen3-1.7b train step counted live (t17) (forward)":
                                 {"launches": per, "wgmma": per}},
             "flash_attention_bwd": {"qwen3-1.7b train step counted live (t17)":
                                     {"launches": per, "wgmma": per}}}
    return paths, numbers


def profile_train_step(step, params, opt, batch, warm_ms: float, tag: str = "train (t2)",
                       scan: bool = False, flash: bool = True):
    """One more train step under torch.profiler: the device's busy time, its
    idle share against a warm step's wall time, the flash backward kernels'
    share (``flash``: the model has attention), each of them by its own time
    and calls, and the top device ops;
    with ``scan`` also the scan backward's kernels (its own pack, the
    backward, the reduction) and the scan forward's (the forward's pack and
    the chunked kernel). Returns (params, opt, numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()

    dev = device_events(prof)
    busy = sum(t for _, _, t in dev) / 1e3

    def by_name(match):  # each matching kernel by name: [calls, ms]
        out = {}
        for k, n, t in dev:
            if match(k):
                name = kernel_name(k)
                out.setdefault(name, [0, 0.0])
                out[name][0] += n
                out[name][1] += t / 1e3
        return out

    by_kernel = by_name(lambda k: "fa_bwd" in k)
    bwd = sum(ms for _, ms in by_kernel.values())
    fwd = sum(t for k, _, t in dev if "flash_" in k and "fa_bwd" not in k) / 1e3
    if busy <= 0 or (flash and bwd <= 0):
        fail(f"{tag}: the profiler saw busy {busy} ms, flash backward kernels {bwd} ms")
    top = sorted(dev, key=lambda x: -x[2])[:8]
    numbers = dict(busy_ms=busy, bwd_kernels_ms=bwd, fwd_kernels_ms=fwd,
                   bwd_kernels={k: {"calls": n, "ms": ms} for k, (n, ms) in by_kernel.items()})
    scan_text = ""
    if scan:
        sbwd = by_name(lambda k: "selective_scan_bwd" in k)
        sfwd = sum(t for k, _, t in dev if "selective_scan_chunked_kernel" in k
                   or "selective_scan_pack_kernel" in k) / 1e3
        s_ms = sum(ms for _, ms in sbwd.values())
        if s_ms <= 0:
            fail(f"{tag}: the profiler saw no scan backward kernel")
        numbers.update(scan_bwd_kernels_ms=s_ms, scan_fwd_kernels_ms=sfwd,
                       scan_bwd_kernels={k: {"calls": n, "ms": ms}
                                         for k, (n, ms) in sbwd.items()})
        scan_text = (f"; scan backward kernels {s_ms:.1f} ms ({100 * s_ms / busy:.1f} %: "
                     + ", ".join(f"{k} x{n} {ms:.2f} ms" for k, (n, ms) in sorted(sbwd.items()))
                     + f"), scan forward {sfwd:.2f} ms")
    flash_text = (f"flash backward kernels {bwd:.1f} ms ({100 * bwd / busy:.1f} %: "
                  + ", ".join(f"{k} x{n} {ms:.2f} ms" for k, (n, ms) in sorted(by_kernel.items()))
                  + f"), flash forward {fwd:.2f} ms" if flash else "no attention")
    print(f"{tag}: profiled step: device busy {busy:.1f} ms of a warm step's {warm_ms:.1f} "
          f"ms ({100 * (1 - busy / warm_ms):.1f} % idle): {flash_text}{scan_text}; top device ops: "
          + "; ".join(f"{k[:48]} x{n} {t / 1e3:.2f} ms" for k, n, t in top))
    return params, opt, numbers


def phase_train_serve(cfg, params, smi_line):
    """(u) ContiguousKV on the weights (t2) trained: the dense cell's request
    shape (a 4096-token prefix ingested through flash_attention, c = 16, a
    64-token suffix, 16 decode tokens, budget 0.25), a cold and a warm
    request, launches a request and read amplification asserted; TTFT, TPOT.
    First each kernel the requests run is held to its plain version at
    qwen3-1.7b's shapes (16 query heads over 8 kv heads of 128). Returns
    ({kernel: {path: launches}}, {kernel: numbers of that hold})."""
    import numpy as np

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.storage.timing import RealExecutor

    held = phase_kernels(cfg, tag=f"train (u) {cfg.name} kernels")
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    sess, ingest, took = _family_ingest(cfg, params, prefix, fa_variant(cfg))
    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da}
    expect = {"chunk_score": -(-cfg.n_layers // PERIOD), "chunk_attention": cfg.n_layers,
              "decode_attention": cfg.n_layers * DECODE_TOKENS}
    eng = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                             budget=BUDGET, period=PERIOD, subperiod=SUBPERIOD)
    reset_counts(*ops.values())
    for i in range(2):
        before = {k: mod.launches for k, mod in ops.items()}
        logits, trace = eng.reprefill(rng.integers(0, cfg.vocab_size, SUFFIX_LEN), request_id=i,
                                      decode_tokens=DECODE_TOKENS)
        got = {k: mod.launches - before[k] for k, mod in ops.items()}
        toks = trace.decode_tokens_out
        if (got != expect or trace.read_amplification != 1.0 or not np.isfinite(logits).all()
                or len(toks) != DECODE_TOKENS):
            fail(f"train (u) request {i}: launches {got} (expected {expect}), read amplification "
                 f"{trace.read_amplification}, {len(toks)} tokens")
        print(f"train (u): request {i} ({'cold' if i == 0 else 'warm'}) on the trained weights: "
              f"TTFT {trace.ttft * 1e3:.2f} ms, TPOT {trace.tpot * 1e3:.3f} ms over "
              f"{trace.n_decoded} tokens, read amplification {trace.read_amplification}, "
              f"launches {got}; ingest {took:.2f} s ({smi_line})")
    eng.ex.shutdown()
    paths = {k: {"qwen3-1.7b requests on trained weights": counts(mod)}
             for k, mod in ops.items()}
    paths["flash_attention"] = {"qwen3-1.7b ingest on trained weights": ingest}
    return paths, held


def fa_variant(cfg) -> str:
    from repro_torch.kernels.flash_attention import ops as fa

    return fa.variant_for(cfg.activation_dtype(), cfg.d_head)


def _cosines(a, b):
    """{leaf: cosine} of two gradient trees in float32, and the smallest."""
    import torch

    from repro_torch.tree import path_key, tree_flatten_with_path, tree_leaves

    out = {path_key(p): torch.nn.functional.cosine_similarity(
        x.float().reshape(-1), y.float().reshape(-1), dim=0).item()
        for (p, x), y in zip(tree_flatten_with_path(a), tree_leaves(b))}
    return out, min(out.items(), key=lambda kv: kv[1])


def _rel_norms(a, b):
    """{leaf: ||a - b|| / ||b||} of two gradient trees in float32, and the
    largest."""
    from repro_torch.tree import path_key, tree_flatten_with_path, tree_leaves

    out = {path_key(p): ((x.float() - y.float()).norm() / y.float().norm()).item()
           for (p, x), y in zip(tree_flatten_with_path(a), tree_leaves(b))}
    return out, max(out.items(), key=lambda kv: kv[1])


def phase_train_agree(cfg, smi_line):
    """(t3) at full width cut to AGREE_LAYERS layers, bfloat16, one 4096-token
    row: the kernel path's loss and gradients against the card's plain path
    (block-wise attention through autograd); remat True and "dots" against False;
    grad_accum 2 against 1 on a batch of two rows; one int8-compressed step
    against AdamW on the gradients quantized by hand."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.steps import make_train_step, make_value_and_grad
    from repro_torch.train.compression import quantize_dequantize_tree
    from repro_torch.train.optimizer import adamw_init, adamw_update
    from repro_torch.tree import path_key, tree_flatten_with_path, tree_leaves

    cfg4 = dataclasses.replace(cfg, n_layers=AGREE_LAYERS)
    params = _init_weights("train (t3)", cfg4)
    one = _train_batch(cfg4, 1, TRAIN_SEQ, 31)
    two = _train_batch(cfg4, 2, TRAIN_SEQ, 37)
    vg = make_value_and_grad(cfg4, remat=False)
    l_k, g_k = vg(params, one)
    before = (fa.launches, fa.bwd_launches)
    with plain_attention():
        l_p, g_p = vg(params, one)
    if (fa.launches, fa.bwd_launches) != before:
        fail("train (t3): the plain path launched a flash kernel")
    rel = abs(l_k.item() - l_p.item()) / abs(l_p.item())
    cos, (worst, wc) = _cosines(g_k, g_p)
    norms, (worst_n, wn) = _rel_norms(g_k, g_p)
    print(f"train (t3): kernel path against the plain path, {AGREE_LAYERS} layers: loss "
          f"{l_k.item():.6f} vs {l_p.item():.6f} (relative {rel:.2e}, limit {AGREE_LOSS_REL}); "
          f"gradient cosine per leaf >= {wc:.6f} ({worst}; limit {AGREE_MIN_COS}); "
          f"||g_k - g_p|| / ||g_p|| per leaf <= {wn:.3e} ({worst_n}; limit "
          f"{AGREE_MAX_REL_NORM}): " + ", ".join(f"{k} {v:.2e}" for k, v in norms.items()))
    if not (rel <= AGREE_LOSS_REL and wc >= AGREE_MIN_COS and wn <= AGREE_MAX_REL_NORM):
        fail("train (t3): the kernel path's loss or gradients disagree with the plain path")
    rdiff = {}
    for remat in (True, "dots"):
        l_r, g_r = make_value_and_grad(cfg4, remat=remat)(params, one)
        differ = [(path_key(p), (x.float() - y.float()).abs().max().item())
                  for (p, x), y in zip(tree_flatten_with_path(g_r), tree_leaves(g_k))
                  if not torch.equal(x, y)]
        rcos = min(_cosines(g_r, g_k)[0].values())
        print(f"train (t3): remat {remat!r} against False: loss bit for bit "
              f"{torch.equal(l_r, l_k)}, {len(tree_leaves(g_k)) - len(differ)} of "
              f"{len(tree_leaves(g_k))} gradient leaves bit for bit"
              + (f"; first differing leaf {differ[0][0]}, largest difference "
                 f"{max(d for _, d in differ):.3g}" if differ else ""))
        if rcos < AGREE_MIN_COS:
            fail(f"train (t3): remat {remat!r}'s gradients disagree (cosine {rcos})")
        rdiff[str(remat)] = len(differ)
        del g_r
    l_1, g_1 = make_value_and_grad(cfg4, grad_accum=1, remat=False)(params, two)
    l_2, g_2 = make_value_and_grad(cfg4, grad_accum=2, remat=False)(params, two)
    rel2 = abs(l_2.item() - l_1.item()) / abs(l_1.item())
    _, (worst2, wc2) = _cosines(g_2, g_1)
    print(f"train (t3): grad_accum 2 against 1 on 2 x {TRAIN_SEQ} tokens: loss {l_2.item():.6f} "
          f"vs {l_1.item():.6f} (relative {rel2:.2e}, limit {ACCUM_LOSS_REL}); gradient cosine "
          f"per leaf >= {wc2:.6f} ({worst2}; limit {ACCUM_MIN_COS}); accumulators "
          f"{tree_leaves(g_2)[0].dtype}")
    if not (rel2 <= ACCUM_LOSS_REL and wc2 >= ACCUM_MIN_COS):
        fail("train (t3): grad_accum 2 disagrees with 1")
    del g_p, g_1, g_2
    opt = adamw_init(params)
    p_c, _, m_c = make_train_step(cfg4, remat=False, lr=TRAIN_LR,
                                  grad_compression="int8")(params, opt, one)
    q = quantize_dequantize_tree(g_k)
    p_h, _ = adamw_update(q, opt, params, lr=TRAIN_LR)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(p_c), tree_leaves(p_h)))
    qerr = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(tree_leaves(q), tree_leaves(g_k)))
    # half an int8 level, then the dequantized value rounded to the gradient's dtype
    qtol = 0.5 / 127 + torch.finfo(cfg.activation_dtype()).eps / 2
    print(f"train (t3): int8-compressed step: loss {m_c['loss'].item():.6f} (bit for bit the "
          f"kernel path's {torch.equal(m_c['loss'], l_k)}), params bit for bit AdamW on the "
          f"hand-quantized gradients {same}, largest quantization error {qerr:.4f} of a leaf's "
          f"largest gradient (limit {qtol:.4f}: half a level and half an ulp)")
    if not (same and torch.equal(m_c["loss"], l_k) and qerr <= qtol):
        fail("train (t3): the int8-compressed step disagrees")
    del params, opt, p_c, p_h, q, g_k
    free_weights()
    return dict(loss_rel=rel, min_cos=wc, max_rel_norm=wn, remat_leaves_differing=rdiff,
                accum_loss_rel=rel2, accum_min_cos=wc2)


def phase_train_restart(smi_line):
    """(t4) the train CLI at --preset 100m: 6 steps with a checkpoint every 3,
    then a rerun to 9 that resumes at step 6; then make_train_step with a
    FailureInjector on a bfloat16 model at qwen3's head dim (a checkpoint each
    step, a failure at step 3, a restart from the newest checkpoint): the
    params and moments bit for bit an uninterrupted run's."""
    import io
    import tempfile

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.launch import train as ptrain
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.ft import FailureInjector
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.tree import tree_leaves

    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for steps in (6, 9):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                ptrain.main(["--preset", "100m", "--steps", str(steps), "--ckpt-dir", tmp,
                             "--ckpt-every", "3", "--log-every", "3", "--device", DEVICE])
            outs.append(buf.getvalue())
            for line in buf.getvalue().splitlines():
                print(f"train (t4): cli --steps {steps}: {line}")
        if ("restored checkpoint" in outs[0]
                or "restored checkpoint, resuming at step 6" not in outs[1]):
            fail("train (t4): the CLI did not resume at step 6")
    cfg = reduced_config(RESTART_ARCH, **RESTART_OVERRIDES)
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    opt = adamw_init(params)
    batch = _train_batch(cfg, 4, 256, 41)
    step_fn = make_train_step(cfg, remat=False, lr=1e-3)
    injector = FailureInjector(fail_at=[3])
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=2)

        def run(p, o, start, save=True):
            for s in range(start, 6):
                if save:
                    injector.maybe_fail(s)
                p, o, _ = step_fn(p, o, batch)
                if save:
                    mgr.save(s, {"params": p, "opt": o}, blocking=True)
            return p, o

        try:
            run(params, opt, 0)
            fail("train (t4): the injected failure did not fire")
        except RuntimeError as e:
            if "injected node failure at step 3" not in str(e):
                raise
        latest = mgr.latest()
        restored = mgr.restore({"params": params, "opt": opt})
        p, o = run(restored["params"], restored["opt"], latest + 1)
        p2, o2 = run(params, opt, 0, save=False)
    a, b = tree_leaves({"params": p, "opt": o}), tree_leaves({"params": p2, "opt": o2})
    same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    print(f"train (t4): {cfg.name} ({cfg.dtype}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}): failed at step 3, resumed at "
          f"step {latest + 1} from the checkpoint of step {latest}; params and moments after step "
          f"5 bit for bit the uninterrupted run's: {same} ({len(a)} leaves)")
    if latest != 2 or not same:
        fail("train (t4): the restarted run differs from the uninterrupted one")
    free_weights()


def phase_train_scan_kernel(hcfg, fcfg, smi_line):
    """(t5) selective_scan's backward kernel against its plain version at
    hymba-1.5b's training shape (b 1, s 4096, d_in 3200, n 16, bfloat16 x, B
    and C as slices of the projection, bfloat16-rounded dt, random float32
    dy, dh_final zero), at falcon-mamba-7b's (d_in 8192), and at hymba's with
    an h0 and a nonzero dh_final: each gradient's error, two runs bit for
    bit, one call counted; the first two timed beside their bound, the plain
    version (one call to a synchronize) and the wrapper's host time; the
    forward with and without its carry stores, the same bits, both timed.
    First the backward kernel's registers and spill bytes (ptxas -v, every
    instance) and its CTAs an SM at this shape. Returns {label: numbers},
    with the kernel's under "design"."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref

    gen = torch.Generator(device=DEVICE).manual_seed(25)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    n, s = hcfg.ssm_state, TRAIN_SEQ
    ptx = ptxas_info("selective_scan_bwd_kernel")
    (regs, st_b, ld_b), = [v for k, v in ptx.items() if f"bfloat16Li{n}E" in k]
    spilling = {k: v for k, v in ptx.items() if v[1] or v[2]}
    ctas = ss.bwd_ctas_per_sm(n, torch.bfloat16)
    print(f"train (t5): selective_scan_bwd_kernel<bfloat16, {n}> (ptxas -v, {B_LOG}): {regs} "
          f"registers, {st_b} / {ld_b} bytes of spill stores / loads; {len(ptx)} instances, "
          f"{len(spilling)} of them spilling (up to {max(v[0] for v in ptx.values())} registers); "
          f"{ctas} CTAs of 256 threads an SM (occupancy calculator), {8 * ctas} warps")
    rows = {"design": dict(registers=regs, spill_store_bytes=st_b, spill_load_bytes=ld_b,
                           instances=len(ptx), instances_spilling=len(spilling),
                           ctas_per_sm=ctas)}
    for label, d_in, seeded in (("hymba", hcfg.d_inner, False),
                                ("falcon-mamba", fcfg.d_inner, False),
                                ("hymba h0 dh_final", hcfg.d_inner, True)):
        x = rn(1, s, d_in)
        dt = F.softplus(rn(1, s, dtype=torch.float32) - 2.0).to(torch.bfloat16)
        A = -torch.exp(rn(d_in, n, dtype=torch.float32))
        proj = rn(1, s, 2 * n + 1)
        h0 = rn(1, d_in, n, dtype=torch.float32) if seeded else None
        dh = rn(1, d_in, n, dtype=torch.float32) if seeded else None
        dy = rn(1, s, d_in, dtype=torch.float32)
        fargs = (x, dt, A, proj[..., :n], proj[..., n: 2 * n], h0)
        carries = ss.carries_buffer(x, n)
        with torch.no_grad():
            y0, hf0 = ss.selective_scan(*fargs)
            y1, hf1 = ss.selective_scan(*fargs, carries=carries)
        if not (torch.equal(y0, y1) and torch.equal(hf0, hf1)):
            fail(f"train (t5) {label}: the forward with carries differs from the one without")
        del y0, hf0, y1, hf1
        args, kw = (*fargs, dy, dh), dict(carries=carries)
        before = ss.bwd_launches
        got = ss.selective_scan_bwd(*args, **kw)
        if ss.bwd_launches != before + 1:
            fail(f"train (t5) {label}: {ss.bwd_launches - before} backward calls counted")
        same = all(torch.equal(a, b) for a, b in zip(got, ss.selective_scan_bwd(*args, **kw)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = selective_scan_bwd_ref(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = {k: max_err(g, w) for k, g, w in zip(SCAN_BWD_GRADS, got, want)}
        tols = {k: (SCAN_BWD_F32_REL if g.dtype == torch.float32 else FLASH_REL)
                * w.float().abs().max().item() for k, g, w in zip(SCAN_BWD_GRADS, got, want)}
        if not same or any(errs[k] > tols[k] for k in errs):
            fail(f"selective_scan_bwd {label}: errors {errs} (tolerances {tols}), two runs "
                 f"bit-identical: {same}")
        elems = s * d_in * n
        r = dict(err=max(errs.values()), errs=errs, tols=tols, bit_identical=same, plain_ms=plain_ms,
                 bound=work_bounds("selective_scan_bwd", b=1, s=s, d_in=d_in, n=n,
                                   itemsize=x.element_size(), dt_itemsize=dt.element_size(),
                                   h0=seeded, dh_final=seeded),
                 exp_ms=elems / EXP_PER_S * 1e3)
        text = ""
        if not seeded:
            r.update(ms=device_ms(lambda: ss.selective_scan_bwd(*args, **kw), reps=10),
                     host_ms=host_ms(lambda: ss.selective_scan_bwd(*args, **kw), reps=10),
                     fwd_ms=device_ms(lambda: ss.selective_scan(*fargs), reps=10),
                     fwd_carries_ms=device_ms(lambda: ss.selective_scan(*fargs, carries=carries),
                                              reps=10))
            cc = r["bound"]["cuda_core"]
            text = (f"; {r['ms']:.4f} ms on the card, plain version {plain_ms:.1f} ms (one call), "
                    f"{bound_text(r['bound'])} ({SCAN_BWD_OPS} float32 operations and one "
                    f"exponential per (t, d, j): the larger, {cc[0]:.5f} ms by {cc[2]}, is its "
                    f"bound), host time per call {r['host_ms']:.4f} ms; library call: none, no "
                    f"PyTorch call computes the scan's backward; the forward {r['fwd_ms']:.4f} "
                    f"ms, with its carry stores {r['fwd_carries_ms']:.4f} ms")
        print(f"train (t5): selective_scan_bwd {label} (x (1, {s}, {d_in}) {dname(x)}, n {n}, "
              f"h0 {'yes' if seeded else 'no'}, dh_final {'random' if seeded else 'zero'}): max "
              f"abs err " + ", ".join(f"{k} {errs[k]:.3g} (tol {tols[k]:.3g})"
                                      for k in SCAN_BWD_GRADS)
              + f", two runs bit-identical{text} ({smi_line})")
        rows[label] = r
        del x, dy, proj, got, want, args, kw, carries, fargs
        free_weights()
    return rows


@contextlib.contextmanager
def plain_scan():
    """The mamba block's scan under grad as selective_scan_ref through
    autograd (the CPU path's plain version), on the card."""
    import types

    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.models import ssm as M

    saved = M.SelectiveScanFn
    M.SelectiveScanFn = types.SimpleNamespace(apply=selective_scan_ref)
    try:
        yield
    finally:
        M.SelectiveScanFn = saved


def _ssm_train_counts():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss

    return {"scan forward chunked": ss.launches_by_variant["chunked"],
            "scan forward sequential": ss.launches_by_variant["sequential"],
            "scan backward": ss.bwd_launches, "flash forward": fa.launches,
            "flash backward": fa.bwd_launches}


def phase_train_ssm_steps(cfg, steps: int, tag: str, smi_line, profile: bool = False):
    """make_train_step(grad_accum=2, remat=False, lr=3e-4) on a full-width
    state-space model (seeded bfloat16 weights) over (t2)'s fixed batch of
    2 x 4096 numpy-seeded tokens for ``steps`` steps: the loss falls; each
    step's chunked scan forwards and scan backward calls (2 x layers each),
    no sequential scan, and flash forward and backward launches (2 x layers
    each where the model has attention) asserted; step time, tokens/s,
    model-FLOPs utilisation, peak memory; with ``profile`` one more step
    profiled (the scan backward's and flash backward's shares, each kernel by
    name). Returns ({kernel: launches}, numbers)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import param_bytes
    from repro_torch.train.optimizer import adamw_init

    params = _init_weights(tag, cfg)
    opt = adamw_init(params)
    print(f"{tag}: params {param_bytes(params) / 1e9:.2f} GB, AdamW moments "
          f"{param_bytes({'m': opt['m'], 'v': opt['v']}) / 1e9:.2f} GB")
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 23)
    step = make_train_step(cfg, grad_accum=TRAIN_ACCUM, remat=False, lr=TRAIN_LR)
    per = TRAIN_ACCUM * cfg.n_layers
    attn = per if cfg.has_attention else 0
    expect = {"scan forward chunked": per, "scan forward sequential": 0, "scan backward": per,
              "flash forward": attn, "flash backward": attn}
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, ss)
    fa.bwd_launches = ss.bwd_launches = fa.dout_copies = 0
    fa.bwd_launches_by_variant = dict.fromkeys(fa.bwd_launches_by_variant, 0)
    losses, step_ms = [], []
    for i in range(steps):
        before = _ssm_train_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in _ssm_train_counts().items()}
        if got != expect or not math.isfinite(losses[-1]):
            fail(f"{tag} step {i}: loss {losses[-1]}, launches {got}, expected {expect}")
        print(f"{tag}: step {i}: loss {losses[-1]:.4f}, {step_ms[-1]:.1f} ms, launches {got} "
              f"({smi_line})")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall over {steps} steps: {losses}")
    launches = {"selective_scan": counts(ss), "selective_scan_bwd": {"launches": ss.bwd_launches}}
    if attn:
        launches["flash_attention"] = counts(fa)
        launches["flash_attention_bwd"] = {"launches": fa.bwd_launches,
                                           **{k: v for k, v in fa.bwd_launches_by_variant.items()
                                              if v}}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm = statistics.median(step_ms[1:])
    flops, what = _train_flops(cfg, params, TRAIN_BATCH, TRAIN_SEQ)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps; warm step "
          f"{warm:.1f} ms (median of steps 1-{steps - 1}), {tokens / warm * 1e3:,.0f} tokens/s; "
          f"{flops / 1e12:.1f} TFLOP a step ({what}; the scan's own work is not counted), "
          f"model-FLOPs "
          f"utilisation {100 * flops / (warm / 1e3) / TENSOR_CORE_OPS_PER_S:.1f} % of 989 "
          f"TFLOP/s; peak device memory {peak:.1f} GiB ({smi_line})")
    numbers = dict(layers=cfg.n_layers, losses=losses, step_ms=step_ms, warm_step_ms=warm,
                   tokens_per_s=tokens / warm * 1e3,
                   mfu=flops / (warm / 1e3) / TENSOR_CORE_OPS_PER_S, peak_gib=peak)
    if profile:
        params, opt, prof = profile_train_step(step, params, opt, batch, warm, tag=tag, scan=True,
                                               flash=bool(attn))
        numbers.update(prof)
    del params, opt, metrics
    free_weights()
    return launches, numbers


def _agreement(tag, label, l_k, g_k, l_p, g_p, loose=None):
    """Prints and checks (t3)'s agreement of (loss, gradients) k against p:
    the loss within AGREE_LOSS_REL relative, every leaf at cosine >=
    AGREE_MIN_COS and within AGREE_MAX_REL_NORM in ||g_k - g_p|| / ||g_p||,
    but for the leaves ``loose`` names, each held to its own (cosine, norm
    ratio). Returns the numbers."""
    loose = loose or {}
    rel = abs(l_k.item() - l_p.item()) / abs(l_p.item())
    cos, _ = _cosines(g_k, g_p)
    norms, _ = _rel_norms(g_k, g_p)
    strict = [k for k in cos if k not in loose]
    wc = min(strict, key=cos.get)
    wn = max(strict, key=norms.get)
    print(f"{tag}: {label}: loss {l_k.item():.6f} vs {l_p.item():.6f} (relative {rel:.2e}, "
          f"limit {AGREE_LOSS_REL}); gradient cosine per leaf >= {cos[wc]:.6f} ({wc}; limit "
          f"{AGREE_MIN_COS}); ||g_k - g_p|| / ||g_p|| per leaf <= {norms[wn]:.3e} ({wn}; limit "
          f"{AGREE_MAX_REL_NORM})"
          + "".join(f"; {k}: cosine {cos[k]:.6f}, norm ratio {norms[k]:.3e} (limits {c}, {r})"
                    for k, (c, r) in loose.items())
          + ": " + ", ".join(f"{k} {v:.2e}" for k, v in norms.items()))
    if not (rel <= AGREE_LOSS_REL and cos[wc] >= AGREE_MIN_COS
            and norms[wn] <= AGREE_MAX_REL_NORM
            and all(cos[k] >= c and norms[k] <= r for k, (c, r) in loose.items())):
        fail(f"{tag}: {label}: the losses or gradients disagree")
    return dict(loss_rel=rel, min_cos=cos[wc], max_rel_norm=norms[wn],
                **{f"{k}_cos": cos[k] for k in loose}, **{f"{k}_rel_norm": norms[k] for k in loose})


def phase_train_ssm_agree(cfg, smi_line):
    """(t7) hymba-1.5b at full width cut to AGREE_LAYERS layers, bfloat16,
    one 4096-token row: the kernel path's loss and gradients (one scan and
    one flash backward a layer) against the card's plain path (block-wise
    attention and selective_scan_ref, both through autograd, no kernel
    launched), and against the path that runs only the scan plain (the
    scan's backward alone); remat True bit for bit no remat."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.tree import path_key, tree_flatten_with_path, tree_leaves

    cfg4 = dataclasses.replace(cfg, n_layers=AGREE_LAYERS)
    params = _init_weights("train (t7)", cfg4)
    one = _train_batch(cfg4, 1, TRAIN_SEQ, 31)
    vg = make_value_and_grad(cfg4, remat=False)
    before = (ss.bwd_launches, fa.bwd_launches)
    l_k, g_k = vg(params, one)
    if (ss.bwd_launches - before[0], fa.bwd_launches - before[1]) != (AGREE_LAYERS,) * 2:
        fail(f"train (t7): backward calls scan {ss.bwd_launches - before[0]}, flash "
             f"{fa.bwd_launches - before[1]}, expected {AGREE_LAYERS} each")
    before = (ss.launches, ss.bwd_launches, fa.launches, fa.bwd_launches)
    with plain_attention(), plain_scan():
        l_p, g_p = vg(params, one)
    if (ss.launches, ss.bwd_launches, fa.launches, fa.bwd_launches) != before:
        fail("train (t7): the plain path launched a kernel")
    out = {"plain": _agreement("train (t7)", f"{cfg.name} kernel path against the plain path, "
                               f"{AGREE_LAYERS} layers", l_k, g_k, l_p, g_p,
                               loose={"layers/mamba/dt_bias": DT_BIAS_LIMITS})}
    del g_p
    before = (ss.launches, ss.bwd_launches, fa.bwd_launches)
    with plain_scan():
        l_s, g_s = vg(params, one)
    if (ss.launches, ss.bwd_launches, fa.bwd_launches - before[2]) != (
            before[0], before[1], AGREE_LAYERS):
        fail("train (t7): the plain scan's path launched a scan kernel or no flash backward")
    out["scan"] = _agreement("train (t7)", "the scan alone: the kernel path against flash "
                             "attention with the plain scan", l_k, g_k, l_s, g_s)
    del g_s
    l_r, g_r = make_value_and_grad(cfg4, remat=True)(params, one)
    differ = [path_key(p) for (p, x), y in zip(tree_flatten_with_path(g_r), tree_leaves(g_k))
              if not torch.equal(x, y)]
    print(f"train (t7): remat True against False: loss bit for bit {torch.equal(l_r, l_k)}, "
          f"{len(tree_leaves(g_k)) - len(differ)} of {len(tree_leaves(g_k))} gradient leaves bit "
          f"for bit" + (f"; differing: {differ}" if differ else ""))
    if differ or not torch.equal(l_r, l_k):
        fail("train (t7): remat True is not bit for bit no remat")
    del params, g_k, g_r
    free_weights()
    out["remat_leaves_differing"] = len(differ)
    return out


def phase_train_ssm(smi_line):
    """(t5)-(t8): the scan's backward kernel, full-width hymba-1.5b trained,
    its 4-layer agreement, falcon-mamba-7b cut in depth trained. Returns
    ({forward kernel: {path: launches}}, the scan backward's row, {path:
    flash_attention_bwd launches})."""
    from repro_torch.configs import get_config

    hcfg, fcfg = get_config(SSM_TRAIN_NAME), get_config(FALCON_TRAIN_NAME)
    t_phase = time.perf_counter()
    kern = phase_train_scan_kernel(hcfg, fcfg, smi_line)
    h_paths, h_step = phase_train_ssm_steps(hcfg, TRAIN_STEPS, "train (t6)", smi_line,
                                            profile=True)
    agree = phase_train_ssm_agree(hcfg, smi_line)
    f_cfg = dataclasses.replace(fcfg, n_layers=FALCON_TRAIN_LAYERS)
    f_paths, f_step = phase_train_ssm_steps(f_cfg, FALCON_TRAIN_STEPS, "train (t8)", smi_line,
                                            profile=True)
    h_path = f"{hcfg.name} {TRAIN_STEPS} train steps"
    f_path = f"{fcfg.name} ({FALCON_TRAIN_LAYERS} layers) {FALCON_TRAIN_STEPS} train steps"
    paths = {}  # the forward kernels'
    for path, by_kernel in ((h_path, h_paths), (f_path, f_paths)):
        for name in ("selective_scan", "flash_attention"):
            if name in by_kernel:
                paths.setdefault(name, {})[f"{path} (forward)"] = by_kernel[name]
    r, fr = kern["hymba"], kern["falcon-mamba"]
    row = {"name": "selective_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/selective_scan.cu",
           "replaces": "src/repro/kernels/selective_scan/kernel.py:55",
           "replaces_note": "the TPU kernel has no backward: the JAX package differentiates its "
                            "jnp chunked scan (src/repro/models/ssm.py:16)",
           "launches": h_paths["selective_scan_bwd"]["launches"]
           + f_paths["selective_scan_bwd"]["launches"],
           "launches_by_path": {h_path: h_paths["selective_scan_bwd"],
                                f_path: f_paths["selective_scan_bwd"]},
           "launches_per_training_step": TRAIN_ACCUM * hcfg.n_layers,
           "max_abs_err": r["err"], "errs": r["errs"], "tols": r["tols"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "bound_ms": r["bound"]["cuda_core"][0],
           "bound_by": r["bound"]["cuda_core"][1], "bound_term": r["bound"]["cuda_core"][2],
           "exponential_bound_ms": r["exp_ms"],
           "library_ms": None, "host_ms": r["host_ms"],
           "forward_ms": r["fwd_ms"], "forward_with_carries_ms": r["fwd_carries_ms"],
           **{k: kern["design"][k] for k in ("registers", "spill_store_bytes",
                                              "spill_load_bytes", "ctas_per_sm")},
           "falcon_mamba": {"ms": fr["ms"], "plain_ms": fr["plain_ms"], "host_ms": fr["host_ms"],
                            "bound_ms": fr["bound"]["cuda_core"][0],
                            "exponential_bound_ms": fr["exp_ms"],
                            "max_abs_err": fr["err"], "errs": fr["errs"],
                            "forward_ms": fr["fwd_ms"],
                            "forward_with_carries_ms": fr["fwd_carries_ms"]},
           "h0_dh_final": {"errs": kern["hymba h0 dh_final"]["errs"],
                           "tols": kern["hymba h0 dh_final"]["tols"]},
           "train_step": {"hymba-1.5b": h_step, "falcon-mamba-7b": f_step}, "agreement": agree}
    if row["launches"] < 1:
        fail("selective_scan_bwd never launched on the training path")
    print(f"train: state-space training (t5)-(t8) took {time.perf_counter() - t_phase:.1f} s")
    return paths, row, {h_path: h_paths["flash_attention_bwd"]}


def phase_train_swa_agree(cfg, smi_line):
    """(t10) gemma3-4b at full width cut to SWA_AGREE_LAYERS layers (the 5:1
    pattern's five windowed layers and global layer 5, so both mask shapes
    are held), bfloat16, one 4096-token row: the kernel path's loss and
    gradients (one wgmma flash backward a layer) against the card's
    plain path (block-wise attention through autograd, no kernel launched)
    within (t3)'s limits; remat True bit for bit no remat."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.tree import path_key, tree_flatten_with_path, tree_leaves

    cfgn = dataclasses.replace(cfg, n_layers=SWA_AGREE_LAYERS)
    windows = [int(w) for w in cfgn.window_sizes()]
    if 0 not in windows or not any(windows):
        fail(f"train (t10): {SWA_AGREE_LAYERS} layers of {cfg.name} hold windows {windows}: "
             f"not both mask shapes")
    params = _init_weights("train (t10)", cfgn)
    one = _train_batch(cfgn, 1, TRAIN_SEQ, 31)
    vg = make_value_and_grad(cfgn, remat=False)
    before = dict(fa.bwd_launches_by_variant)
    l_k, g_k = vg(params, one)
    got = {k: n - before[k] for k, n in fa.bwd_launches_by_variant.items() if n != before[k]}
    if got != {"wgmma": SWA_AGREE_LAYERS}:
        fail(f"train (t10): flash backward launches {got}, expected {SWA_AGREE_LAYERS} wgmma")
    before = (fa.launches, fa.bwd_launches)
    with plain_attention():
        l_p, g_p = vg(params, one)
    if (fa.launches, fa.bwd_launches) != before:
        fail("train (t10): the plain path launched a flash kernel")
    out = _agreement("train (t10)", f"{cfg.name} kernel path against the plain path, "
                     f"{SWA_AGREE_LAYERS} layers (windows {windows})", l_k, g_k, l_p, g_p)
    del g_p
    l_r, g_r = make_value_and_grad(cfgn, remat=True)(params, one)
    differ = [path_key(p) for (p, x), y in zip(tree_flatten_with_path(g_r), tree_leaves(g_k))
              if not torch.equal(x, y)]
    print(f"train (t10): remat True against False: loss bit for bit {torch.equal(l_r, l_k)}, "
          f"{len(tree_leaves(g_k)) - len(differ)} of {len(tree_leaves(g_k))} gradient leaves bit "
          f"for bit" + (f"; differing: {differ}" if differ else "") + f" ({smi_line})")
    if differ or not torch.equal(l_r, l_k):
        fail("train (t10): remat True is not bit for bit no remat")
    del params, g_k, g_r
    free_weights()
    out["remat_leaves_differing"] = len(differ)
    return out


def phase_train_families(smi_line):
    """(t9)-(t12): gemma3-4b trained at FAMILY_TRAIN_LAYERS[its name]
    layers (the wgmma backward at d 256), its 6-layer agreement, then
    granite-moe-3b-a800m (its MoE dispatch under grad) and musicgen-large
    (frame embeddings) trained, each at the depth FAMILY_TRAIN_LAYERS gives
    it (the wgmma backward at d 64). Returns ({path: {kernel: launches}},
    {model: numbers}, (t10)'s numbers)."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    paths, numbers = {}, {}
    agree = None
    for tag, name in (("train (t9)", SWA_NAME), ("train (t11)", MOE_NAME),
                      ("train (t12)", AUDIO_NAME)):
        full = get_config(name)
        cfg = dataclasses.replace(full, n_layers=FAMILY_TRAIN_LAYERS[name])
        print(f"{tag}: {name} at {cfg.n_layers} of its {full.n_layers} layers: "
              f"{FAMILY_TRAIN_DEPTH_WHY[name]}")
        _, launches, numbers[name] = phase_train_family(cfg, FAMILY_TRAIN_STEPS, tag, smi_line)
        cut = "" if cfg.n_layers == full.n_layers else f" ({cfg.n_layers} layers)"
        paths[f"{name}{cut} {FAMILY_TRAIN_STEPS} train steps"] = launches
        if name == SWA_NAME:
            agree = phase_train_swa_agree(full, smi_line)
    print(f"train: (t9)-(t12) took {time.perf_counter() - t_phase:.1f} s")
    return paths, numbers, agree


# ---------------------------------------------------------------------------
# training over a mesh (t13)-(t16)
# ---------------------------------------------------------------------------
def _host_tree(tree):
    """A tree of tensors (or ShardedTensor leaves, gathered) copied to the
    host, so a reference step's outputs leave the card's memory."""
    from repro_torch.launch.sharding import ShardedTensor, unshard
    from repro_torch.tree import tree_map

    return tree_map(lambda x: unshard(x, "cpu") if isinstance(x, ShardedTensor)
                    else x.detach().to("cpu"), tree)


def _mesh_state(cfg, params, mesh):
    """(params, AdamW's zero state) laid out on ``mesh`` by
    param_shardings(fsdp=True), the step replicated; each moment leaf is made
    and laid out one at a time, so the whole float32 state never sits on the
    card twice."""
    import torch

    from repro_torch.launch.sharding import NamedSharding, P, param_shardings, shard, shard_tree
    from repro_torch.tree import tree_map

    sh = param_shardings(cfg, mesh, fsdp=True)

    def zeros(p, s):
        return shard(torch.zeros(p.shape, dtype=torch.float32, device=p.device), s)

    opt = {"m": tree_map(zeros, params, sh), "v": tree_map(zeros, params, sh),
           "step": shard(torch.zeros((), dtype=torch.int32, device=DEVICE),
                         NamedSharding(mesh, P()))}
    return shard_tree(params, sh), opt, sh


def _mesh_agreement(got_p, got_o, ref_p, ref_o, old_p):
    """The mesh step's new params and moments (ShardedTensor trees) against
    the unsharded step's (host trees): bit for bit, each kind's largest leaf
    difference over the leaf's largest element, the smallest cosine, and
    the relative L2 of the moments and of the params' update (new minus
    ``old_p``, the params before the step), over the whole tree and leaf by
    leaf (``leaf_l2``: kind -> [(leaf, relative L2)] in the tree's order).
    Returns numbers."""
    import torch

    from repro_torch.launch.sharding import unshard
    from repro_torch.tree import path_key, tree_flatten_with_path, tree_leaves

    worst = {k: (0.0, "every leaf") for k in ("params", "m", "v")}
    sums = {k: [0.0, 0.0] for k in ("update", "m", "v")}  # sum (got - ref)^2, sum ref^2
    leaf_l2 = {k: [] for k in ("update", "m", "v")}
    min_cos, bitwise, leaves = (1.0, "every leaf"), True, 0
    olds = tree_leaves(old_p)
    for kind, got, ref in (("params", got_p, ref_p), ("m", got_o["m"], ref_o["m"]),
                           ("v", got_o["v"], ref_o["v"])):
        for i, ((path, g), r) in enumerate(zip(tree_flatten_with_path(got), tree_leaves(ref))):
            g = unshard(g, DEVICE)
            r = r.to(DEVICE)
            leaves += 1
            bitwise &= g.dtype == r.dtype and torch.equal(g, r)
            gf, rf = g.double(), r.double()
            rel = ((gf - rf).abs().max() / rf.abs().max().clamp(min=1e-30)).item()
            if rel > worst[kind][0]:
                worst[kind] = (rel, path_key(path))
            if rf.abs().max() > 0 and gf.abs().max() > 0:
                gd, rd = gf.reshape(-1), rf.reshape(-1)
                cos = (gd @ rd / (gd.norm() * rd.norm())).item()
                if cos < min_cos[0]:
                    min_cos = (cos, f"{kind} {path_key(path)}")
            k = kind
            if kind == "params":
                old = olds[i].double()
                gf, rf, k = gf - old, rf - old, "update"
            a, b = ((gf - rf) ** 2).sum().item(), (rf ** 2).sum().item()
            sums[k][0] += a
            sums[k][1] += b
            leaf_l2[k].append((path_key(path), (a / max(b, 1e-300)) ** 0.5))
            del g, r, gf, rf
    return dict(rel_l2={k: (a / max(b, 1e-300)) ** 0.5 for k, (a, b) in sums.items()},
                leaf_l2=leaf_l2, max_rel={k: v[0] for k, v in worst.items()},
                max_rel_leaf={k: v[1] for k, v in worst.items()}, min_cos=min_cos[0],
                min_cos_leaf=min_cos[1], bit_for_bit=bitwise, leaves=leaves)


def _f32_floor(cfg, params, batch, ref_p, ref_o, accum):
    """The bfloat16 floor of (t13): the unsharded bfloat16 step's (``ref_p``,
    ``ref_o``, host trees) relative distance from a float32 computation of
    the same step, of the first moments, the second moments and the params'
    update, each a relative L2 over the whole tree and over each leaf
    (``leaf``: kind -> [relative L2] in the tree's order), and of the loss:
    the relative L2 of the positions' negative log-likelihoods under the
    bfloat16 and float32 params (``_position_nll``). The float32 step is
    its first half, the loss and gradient of float32 copies of ``params``
    (``make_value_and_grad`` with ``accum`` microbatches, remat), and
    AdamW's first update from zero moments leaf by leaf (m = (1 - b1) c g,
    v = (1 - b2) (c g)^2, the update -lr (m-hat / (sqrt(v-hat) + eps) + wd
    p), c the float32 gradient's clip), so no float32 moment tree sits on
    the card whole. Returns (the floor, the float32 loss, the bfloat16
    params' positions' negative log-likelihoods)."""
    import torch

    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.train.optimizer import clip_scale
    from repro_torch.tree import tree_leaves, tree_map

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda p: p.float(), params)
    nll16, nll32 = (_position_nll(c, p, batch) for c, p in ((cfg, params), (cfg32, params32)))
    loss32, g32 = make_value_and_grad(cfg32, grad_accum=accum, block_q=512, remat=True)(
        params32, batch)
    del params32
    c = clip_scale(g32)
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1  # optimizer.adamw_update's defaults
    sums = {k: [0.0, 0.0] for k in ("update", "m", "v")}
    leaf = {k: [] for k in sums}
    for g, p, rp, rm, rv in zip(tree_leaves(g32), tree_leaves(params), tree_leaves(ref_p),
                                tree_leaves(ref_o["m"]), tree_leaves(ref_o["v"])):
        gc = g * c
        m, v = (1 - b1) * gc, (1 - b2) * torch.square(gc)
        pf = p.float()
        upd = -TRAIN_LR * ((m / (1 - b1)) / (torch.sqrt(v / (1 - b2)) + eps) + wd * pf)
        for k, want, got in (("m", m, rm.to(DEVICE)), ("v", v, rv.to(DEVICE)),
                             ("update", upd, rp.to(DEVICE).float() - pf)):
            a = ((got.double() - want.double()) ** 2).sum().item()
            b = (want.double() ** 2).sum().item()
            sums[k][0] += a
            sums[k][1] += b
            leaf[k].append((a / max(b, 1e-300)) ** 0.5)
        del gc, m, v, pf, upd
    del g32
    floor = {k: (a / max(b, 1e-300)) ** 0.5 for k, (a, b) in sums.items()}
    floor.update(loss=_rel_l2(nll16, nll32), leaf=leaf)
    return floor, float(loss32), nll16


def _position_nll(cfg, params, batch):
    """Each position's negative log-likelihood of its label under
    ``params``, in the batch's row order, float32: forwards without grad, a
    row at a time."""
    import torch

    from repro_torch.models import transformer as T

    rows = []
    with torch.no_grad():
        for r in range(batch["labels"].shape[0]):
            mb = {k: v[r: r + 1] for k, v in batch.items()}
            logp = torch.log_softmax(T.forward(params, mb, cfg), dim=-1)
            rows.append(-logp.gather(-1, mb["labels"][..., None].long())[..., 0].reshape(-1))
            del logp
    return torch.cat(rows).float()


def _recorded_nll():
    """Wraps ``tp_compute.vocab_cross_entropy`` to record, from each call's
    vocabulary shards' logits, its positions' negative log-likelihoods
    (each row's log-sum-exp joined over the shards, less the label's logit
    from the shard that owns it), in the order of the calls: a mesh train
    step's dp parts, in its batch's row order. Returns (the record, a
    function that restores the wrapper)."""
    import torch

    from repro_torch.launch import tp_compute as TPC

    seen, real = [], TPC.vocab_cross_entropy

    def recording(zs, labels, mask, home, n, shards=None):
        with torch.no_grad():
            lse, zl = [], torch.zeros(labels.shape, dtype=torch.float32, device=home)
            for t in sorted(zs):
                z, v0 = zs[t]
                lse.append(torch.logsumexp(z, dim=-1).to(home))
                idx = labels.to(z.device).long() - v0
                own = (idx >= 0) & (idx < z.shape[-1])
                zl += torch.where(own, z.gather(-1, idx.clamp(0, z.shape[-1] - 1)[..., None])
                                  [..., 0], 0.0).to(home)
            seen.append((torch.logsumexp(torch.stack(lse), dim=0) - zl).reshape(-1))
        return real(zs, labels, mask, home, n, shards)

    TPC.vocab_cross_entropy = recording

    def restore():
        TPC.vocab_cross_entropy = real

    return seen, restore


def _hold_to_floor(tag, agree, floor) -> dict:
    """Fails unless the mesh step's distance from the unsharded step is
    within MESH_FLOOR_X x ``floor`` (``_f32_floor``), like for like: the
    positions' negative log-likelihoods' relative L2 (``agree["loss"]``)
    against the positions' floor; the moments' and the update's relative
    L2 over the whole tree against the tree's floor, and over each leaf
    against the larger of that leaf's own floor and the tree's (a leaf the
    unsharded step computes almost exactly in bfloat16, a float32 norm
    scale, or one of a few dozen elements, such as hymba's per-layer
    ``dt_bias``, has an own floor far below the step's rounding, which the
    mesh step's other roundings upstream move it by). Prints the readings,
    the limits and each kind's worst leaf; returns the limits."""
    limits = {k: MESH_FLOOR_X * floor[k] for k in ("loss", "m", "v", "update")}
    readings = {"loss": agree["loss"], **agree["rel_l2"]}
    worst, failed = {}, [k for k in limits if readings[k] > limits[k]]
    for k, got in agree["leaf_l2"].items():
        ratios = []
        for (name, x), own in zip(got, floor["leaf"][k]):
            f = max(own, floor[k])
            ratios.append((x / f if f > 0 else (0.0 if x == 0 else math.inf), name, x, own))
        worst[k] = max(ratios)
        failed += [f"{k} {name}" for r, name, *_ in ratios if r > MESH_FLOOR_X]
    print(f"{tag}: step 1 against the unsharded step, relative L2 (the loss: of the "
          f"positions' negative log-likelihoods): {_fmt(readings)}; limits ({MESH_FLOOR_X:g}x "
          f"the floor): {_fmt(limits)}; each leaf against {MESH_FLOOR_X:g}x the larger of its "
          f"own floor and the tree's, the worst of each kind (reading, own floor, reading over "
          f"the floor held): " + ", ".join(f"{k} {name} {x:.3g}, {own:.3g}, {r:.3g}"
                                           for k, (r, name, x, own) in worst.items()))
    if failed:
        fail(f"{tag}: the tensor-parallel step is farther from the unsharded step than "
             f"{MESH_FLOOR_X:g}x the bfloat16 floor: {failed}")
    return dict(limits, worst_leaf_ratio={k: w[0] for k, w in worst.items()},
                worst_leaf={k: w[1] for k, w in worst.items()})


def _flash_shapes():
    """Wraps the flash wrappers to record each launch's (q heads, kv
    heads); returns (the record, a function that restores them). The
    launch counts are the wrappers' own."""
    from repro_torch.kernels.flash_attention import ops as fa

    seen = {"forward": set(), "backward": set()}
    real_f, real_b = fa.flash_attention, fa.flash_attention_bwd

    def fwd(q, k, v, **kw):
        seen["forward"].add((q.shape[1], k.shape[1], fa.variant_for(q.dtype, q.shape[-1])))
        return real_f(q, k, v, **kw)

    def bwd(q, k, v, *a, **kw):
        seen["backward"].add((q.shape[1], k.shape[1], fa.bwd_variant_for(q.dtype, q.shape[-1])))
        return real_b(q, k, v, *a, **kw)

    fa.flash_attention, fa.flash_attention_bwd = fwd, bwd

    def restore():
        fa.flash_attention, fa.flash_attention_bwd = real_f, real_b

    return seen, restore


def _flash_step_counts(tag, expect):
    """Resets the flash wrappers' counts; returns a function that reads them
    after the step and fails unless they are ``expect``."""
    from repro_torch.kernels.flash_attention import ops as fa

    reset_counts(fa)
    fa.bwd_launches = 0
    fa.bwd_launches_by_variant = dict.fromkeys(fa.bwd_launches_by_variant, 0)

    def read():
        got = {"flash forward": fa.launches, "flash backward": fa.bwd_launches}
        if got != expect:
            fail(f"{tag}: flash launches {got}, expected {expect}")
        return {"flash_attention": counts(fa),
                "flash_attention_bwd": {"launches": fa.bwd_launches,
                                        **{k: n for k, n in fa.bwd_launches_by_variant.items()
                                           if n}}}

    return read


def _timed(fn):
    """(fn(), its ms to a synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _mesh_join_ms(cfg, ps, opt, mesh):
    """(t13)'s joins alone, by events: one layer's weight slices gathered
    for every mesh position (``MeshServe._weights`` under grad, the
    forward of ``_WeightGather``), then the same with each slice's backward
    (a gradient of ones added into the float32 block accumulators, the
    reduce-scatter), and AdamW on the blocks (``mesh_update``). Returns
    (gather ms, gather and reduce ms) a layer, and the update's ms."""
    import torch

    from repro_torch.launch.steps import mesh_update
    from repro_torch.launch.tp_compute import GradSink, MeshServe, _Part, _Train
    from repro_torch.tree import tree_leaves

    model = MeshServe(cfg, mesh)

    def layer(sink, backward):
        for j in range(model.n_dp):
            part = _Part(j, slice(0, 1), mesh.devices[model.pos(j, 0)], model.pos(j, 0), None,
                         0, False, 1.0, train=_Train(sink, 0.5))
            part.train.open_scope()
            with torch.enable_grad():
                for t in range(model.n_tp):
                    pos = model.pos(j, t)
                    w = tree_leaves(model._weights(ps, 0, model.shards[t], mesh.devices[pos],
                                                   pos, part))
                    if backward:
                        torch.autograd.backward(w, [torch.ones_like(x) for x in w])

    sink = GradSink(ps)  # the gathers' scopes stay open: this sink is never finished
    gather_ms = device_ms(lambda: layer(sink, False), reps=5)
    del sink
    sink = GradSink(ps)
    both_ms = device_ms(lambda: layer(sink, True), reps=5)
    grads = sink.finish(lambda st, a: a)
    one = torch.ones((), dtype=torch.float32, device=DEVICE)
    update_ms = device_ms(lambda: mesh_update(grads, opt, ps, lr=TRAIN_LR, scale=one), reps=3)
    del sink, grads
    return gather_ms, both_ms, update_ms


def phase_train_mesh_qwen(cfg, params, smi_line):
    """(t13) full-width qwen3-1.7b on a 2 x 2 mesh of the card ([cuda:0] x
    4, fsdp): MESH_STEPS tensor-parallel steps of grad_accum MESH_ACCUM over
    MESH_BATCH x TRAIN_SEQ seeded tokens, each layer on its tensor shard's
    8 / 4 heads, 3072 d_ff columns and 75968 vocabulary columns. Step 1 held
    to the unsharded step over the same rows with grad_accum MESH_BATCH
    (each dp part's rows one unsharded microbatch), within MESH_FLOOR_X x
    the floor measured here: that step's own relative distance from a
    float32 computation of it (``_f32_floor``), for the loss, the moments
    and the params' update. The step ms beside the unsharded step's, peak
    memory, the per-layer gathers, their reduce and AdamW by events, the
    flash launches and their heads a step. (t13b) the same batch on a 2 x 1
    mesh (one tensor shard): one step bit for bit the unsharded step's.
    Returns ({kernel: {path: launches}}, numbers)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import adamw_init

    tag = "train (t13)"
    n_tp = 2
    batch = _train_batch(cfg, MESH_BATCH, TRAIN_SEQ, 29)
    per_row = MESH_BATCH * cfg.n_layers  # the unsharded step: one call a layer and row
    per_step = per_row * n_tp  # the mesh: one a layer, dp part, tensor shard and microbatch
    paths = {"flash_attention": {}, "flash_attention_bwd": {}}
    ref_step = make_train_step(cfg, grad_accum=MESH_BATCH, remat=False, lr=TRAIN_LR)
    ref_step(params, adamw_init(params), batch)  # warm-up, its result dropped
    free_weights()
    torch.cuda.reset_peak_memory_stats()
    read = _flash_step_counts(tag, {"flash forward": per_row, "flash backward": per_row})
    (rp, ro, rm), ref_ms = _timed(lambda: ref_step(params, adamw_init(params), batch))
    read()
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    ref_loss = float(rm["loss"])
    ref_p, ref_o = _host_tree(rp), _host_tree({"m": ro["m"], "v": ro["v"]})
    del rp, ro, rm
    free_weights()
    print(f"{tag}: the unsharded step (grad_accum {MESH_BATCH}, one row a microbatch): loss "
          f"{ref_loss:.6f}, {ref_ms:.1f} ms, peak {ref_peak:.1f} GiB ({smi_line})")
    t0 = time.perf_counter()
    floor, loss32, ref_nll = _f32_floor(cfg, params, batch, ref_p, ref_o, MESH_BATCH)
    free_weights()
    print(f"{tag}: the bfloat16 floor, the unsharded step's relative distance from its float32 "
          f"computation (float32 loss {loss32:.6f}): "
          f"{_fmt({k: v for k, v in floor.items() if k != 'leaf'})} "
          f"({time.perf_counter() - t0:.1f} s)")

    mesh = make_host_mesh(2, n_tp, devices=[torch.device(DEVICE, 0)] * 4)
    ps, opt, _ = _mesh_state(cfg, params, mesh)
    step = make_train_step(cfg, grad_accum=MESH_ACCUM, remat=False, lr=TRAIN_LR, mesh=mesh)
    losses, step_ms, agree, heads, peak = [], [], None, None, 0.0
    with plain_versions_counted({"flash_attention": fa}) as plain_calls:
        for i in range(MESH_STEPS):
            torch.cuda.reset_peak_memory_stats()
            read = _flash_step_counts(f"{tag} step {i}", {"flash forward": per_step,
                                                          "flash backward": per_step})
            if i == 0:
                heads, restore = _flash_shapes()
                nll, restore_nll = _recorded_nll()
            try:
                (new_ps, new_opt, metrics), ms = _timed(lambda: step(ps, opt, batch))
            finally:
                if i == 0:
                    restore()
                    restore_nll()
            launched = read()
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)  # the step's own
            losses.append(float(metrics["loss"]))
            step_ms.append(ms)
            if plain_calls or not math.isfinite(losses[-1]):
                fail(f"{tag} step {i}: loss {losses[-1]}, plain versions {plain_calls}")
            print(f"{tag}: mesh step {i}: loss {losses[-1]:.4f}, {ms:.1f} ms, launches "
                  f"{launched['flash_attention']} / {launched['flash_attention_bwd']} "
                  f"({smi_line})")
            for k in paths:
                for key, n in launched[k].items():
                    paths[k][key] = paths[k].get(key, 0) + n
            if i == 0:
                agree = _mesh_agreement(new_ps, new_opt, ref_p, ref_o, params)
                agree["loss"] = _rel_l2(torch.cat(nll), ref_nll)
                agree["mean_loss"] = abs(losses[0] - ref_loss) / abs(ref_loss)
            ps, opt = new_ps, new_opt
            del new_ps, new_opt
    want_heads = {(cfg.n_heads // n_tp, cfg.n_kv_heads // n_tp, "wgmma")}
    if heads["forward"] != want_heads or heads["backward"] != want_heads:
        fail(f"{tag}: flash ran at (q heads, kv heads, variant) {heads}, expected {want_heads}")
    limits = _hold_to_floor(tag, agree, floor)
    print(f"{tag}: the mean loss's relative difference {agree['mean_loss']:.3g}; largest leaf "
          f"difference over its largest element {_fmt(agree['max_rel'])}, smallest cosine "
          f"{agree['min_cos']:.7f} ({agree['min_cos_leaf']}); bit for bit: {agree['bit_for_bit']} "
          f"({agree['leaves']} leaves); flash at (q, kv heads, variant) "
          f"{sorted(heads['forward'])} forward, {sorted(heads['backward'])} backward")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall over {MESH_STEPS} steps: {losses}")
    gather_ms, both_ms, update_ms = _mesh_join_ms(cfg, ps, opt, mesh)
    warm = statistics.median(step_ms[1:])
    tokens = MESH_BATCH * TRAIN_SEQ
    print(f"{tag}: {cfg.name} on a 2 x 2 mesh of the card, tensor-parallel: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} over {MESH_STEPS} steps; warm step {warm:.1f} ms (median of "
          f"steps 1-{MESH_STEPS - 1}) against the unsharded step's {ref_ms:.1f} ms over the same "
          f"rows, {tokens / warm * 1e3:,.0f} tokens/s; peak {peak:.1f} GiB (unsharded "
          f"{ref_peak:.1f}; the dp-only 2 x 2 step, whole params gathered on each dp shard: "
          f"53.0 on an H100); "
          f"by events: one layer's weight slices gathered for the 4 positions {gather_ms:.2f} ms, "
          f"with their gradients' reduce {both_ms:.2f} ms (x {cfg.n_layers} layers x "
          f"{MESH_ACCUM} microbatches a step), AdamW on the blocks {update_ms:.2f} ms; flash "
          f"{per_step} forward and {per_step} backward launches a step ({smi_line})")
    numbers = dict(losses=losses, step_ms=step_ms, warm_step_ms=warm, unsharded_step_ms=ref_ms,
                   peak_gib=peak, unsharded_peak_gib=ref_peak, layer_gather_ms=gather_ms,
                   layer_gather_reduce_ms=both_ms, update_ms=update_ms,
                   floor={k: v for k, v in floor.items() if k != "leaf"}, limits=limits,
                   agreement={k: v for k, v in agree.items() if k != "leaf_l2"},
                   flash_heads={k: sorted(v) for k, v in heads.items()})
    del ps, opt, metrics
    free_weights()

    tag = "train (t13b)"
    mesh = make_host_mesh(2, 1, devices=[torch.device(DEVICE, 0)] * 2)
    ps, opt, _ = _mesh_state(cfg, params, mesh)
    read = _flash_step_counts(tag, {"flash forward": per_row, "flash backward": per_row})
    (ps, opt, metrics), ms = _timed(lambda: make_train_step(
        cfg, grad_accum=MESH_ACCUM, remat=False, lr=TRAIN_LR, mesh=mesh)(ps, opt, batch))
    launched = read()
    for k in paths:
        for key, n in launched[k].items():
            paths[k][key] = paths[k].get(key, 0) + n
    b_agree = _mesh_agreement(ps, opt, ref_p, ref_o, params)
    print(f"{tag}: {cfg.name} on a 2 x 1 mesh (one tensor shard, one row a dp part) over "
          f"(t13)'s batch: {ms:.1f} ms against the unsharded {ref_ms:.1f} ms; the loss "
          f"{float(metrics['loss']):.6f} against {ref_loss:.6f}; bit for bit: "
          f"{b_agree['bit_for_bit']} ({b_agree['leaves']} leaves) ({smi_line})")
    if not (b_agree["bit_for_bit"] and float(metrics["loss"]) == ref_loss):
        fail(f"{tag}: the mesh step with one tensor shard is not bit for bit the unsharded step")
    numbers["one_tensor_shard"] = dict(step_ms=ms, unsharded_step_ms=ref_ms, **b_agree)
    del ps, opt, metrics, ref_p, ref_o
    free_weights()
    return paths, numbers


def phase_train_mesh_hybrid(smi_line):
    """hymba-1.5b at full width on a 1 x 2 mesh of the card, one
    tensor-parallel step of grad_accum TRAIN_ACCUM over TRAIN_BATCH x
    TRAIN_SEQ seeded tokens: its 25 heads split ceil-wise 13 / 12 over the
    two tensor shards (each shard's kv heads read one a q head through
    ``kv_index``), its 3200 mamba channels 1600 a shard through the scan's
    forward with carries and its backward, no plain version. Held as (t13):
    within MESH_FLOOR_X x the unsharded step's relative distance from its
    float32 computation (the positions' log-likelihoods, the moments and
    the params' update, over the tree and leaf by leaf). Not in the main
    run (its time limit): ``scripts/phase.py train_mesh_hymba``. Returns
    ({kernel: {path: launches}}, numbers)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import adamw_init

    tag = "train (hymba mesh)"
    cfg = get_config(SSM_TRAIN_NAME)
    params = _init_weights(tag, cfg)
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 37)
    kw = dict(grad_accum=TRAIN_ACCUM, remat=False, lr=TRAIN_LR)
    ref_step = make_train_step(cfg, **kw)
    ref_step(params, adamw_init(params), batch)  # warm-up, dropped
    free_weights()
    (rp, ro, rm), ref_ms = _timed(lambda: ref_step(params, adamw_init(params), batch))
    ref_loss = float(rm["loss"])
    ref_p, ref_o = _host_tree(rp), _host_tree({"m": ro["m"], "v": ro["v"]})
    del rp, ro, rm
    free_weights()
    floor, loss32, ref_nll = _f32_floor(cfg, params, batch, ref_p, ref_o, TRAIN_ACCUM)
    print(f"{tag}: the unsharded step {ref_ms:.1f} ms, loss {ref_loss:.6f} (float32 "
          f"{loss32:.6f}); the bfloat16 floor "
          f"{_fmt({k: v for k, v in floor.items() if k != 'leaf'})} ({smi_line})")
    n_tp = 2
    mesh = make_host_mesh(1, n_tp, devices=[torch.device(DEVICE, 0)] * n_tp)
    ps, opt, _ = _mesh_state(cfg, params, mesh)
    step = make_train_step(cfg, mesh=mesh, **kw)
    per = TRAIN_ACCUM * cfg.n_layers * n_tp  # one a layer, microbatch and tensor shard
    with plain_versions_counted({"flash_attention": fa, "selective_scan": ss}) as plain_calls:
        reset_counts(fa, ss)
        fa.bwd_launches = ss.bwd_launches = 0
        fa.bwd_launches_by_variant = dict.fromkeys(fa.bwd_launches_by_variant, 0)
        heads, restore = _flash_shapes()
        nll, restore_nll = _recorded_nll()
        try:
            (new_ps, new_opt, metrics), ms = _timed(lambda: step(ps, opt, batch))
        finally:
            restore()
            restore_nll()
    got = {"flash forward": fa.launches, "flash backward": fa.bwd_launches,
           "scan forward": ss.launches, "scan backward": ss.bwd_launches}
    if got != dict.fromkeys(got, per) or plain_calls:
        fail(f"{tag}: launches {got}, expected {per} each; plain versions {plain_calls}")
    paths = {"flash_attention": counts(fa),
             "flash_attention_bwd": {"launches": fa.bwd_launches,
                                     **{k: n for k, n in fa.bwd_launches_by_variant.items() if n}},
             "selective_scan": counts(ss), "selective_scan_bwd": {"launches": ss.bwd_launches}}
    loss = float(metrics["loss"])
    print(f"{tag}: mesh step: loss {loss:.4f}, {ms:.1f} ms, launches {paths}; flash at (q, kv "
          f"heads, variant) {sorted(heads['forward'])} / {sorted(heads['backward'])} "
          f"({smi_line})")
    shard_heads = {(13, 13, "wgmma"), (12, 12, "wgmma")}
    if heads["forward"] != shard_heads or heads["backward"] != shard_heads:
        fail(f"{tag}: flash ran at {heads}, expected {shard_heads}")
    if not math.isfinite(loss):
        fail(f"{tag}: loss {loss}")
    agree = _mesh_agreement(new_ps, new_opt, ref_p, ref_o, params)
    agree["loss"] = _rel_l2(torch.cat(nll), ref_nll)
    agree["mean_loss"] = abs(loss - ref_loss) / abs(ref_loss)
    limits = _hold_to_floor(tag, agree, floor)
    print(f"{tag}: {cfg.name} on a 1 x 2 mesh: the mean loss's relative difference "
          f"{agree['mean_loss']:.3g}, smallest cosine {agree['min_cos']:.7f} "
          f"({agree['min_cos_leaf']}); {ms:.1f} ms against the unsharded {ref_ms:.1f} ms "
          f"({smi_line})")
    del ps, opt, new_ps, new_opt, metrics, params, ref_p, ref_o
    free_weights()
    return paths, dict(loss=loss, step_ms=ms, unsharded_step_ms=ref_ms,
                       floor={k: v for k, v in floor.items() if k != "leaf"}, limits=limits,
                       agreement={k: v for k, v in agree.items() if k != "leaf_l2"})


def phase_train_mesh_moe(smi_line):
    """(t14) granite-moe-3b-a800m cut to MOE_MESH_LAYERS layers on the 2 x 2
    mesh for one step of grad_accum MESH_ACCUM over MESH_BATCH x
    MOE_MESH_SEQ tokens, each ``moe.dispatch`` call recorded (top-k ids,
    capacity, keep mask). Held bit for bit: each microbatch's two parts keep
    and drop, layer by layer, exactly what the microbatch's dispatch over the
    parts' routing, concatenated, keeps and drops (the split's own
    invariant). Against the unsharded step over the same microbatches: the
    top-k ids and keep masks that differ, counted from the first layer on
    (the card's GEMMs sum a part's 2048 rows and a microbatch's 4096 in
    other orders, and the tensor shards' partials round to bfloat16 before
    their sum, so a router logit near a tie can flip), and the loss within
    MOE_MESH_LOSS_REL. Returns ({kernel: {path: launches}}, numbers)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as PM
    from repro_torch.train.optimizer import adamw_init

    tag = "train (t14)"
    full = get_config(MOE_NAME)
    cfg = dataclasses.replace(full, n_layers=MOE_MESH_LAYERS)
    print(f"{tag}: {MOE_NAME} at {cfg.n_layers} of its {full.n_layers} layers: the unsharded "
          f"reference and the sharded copy share the card")
    params = _init_weights(tag, cfg)
    batch = _train_batch(cfg, MESH_BATCH, MOE_MESH_SEQ, 31)
    kw = dict(grad_accum=MESH_ACCUM, remat=False, lr=TRAIN_LR)
    seen = []
    real = PM.dispatch

    def recording(top_idx, cap, n_experts, offset=None):
        out = real(top_idx, cap, n_experts, offset)
        seen.append((top_idx, cap, out[1]))
        return out

    per = MESH_ACCUM * cfg.n_layers
    make_train_step(cfg, **kw)(params, adamw_init(params), batch)  # warm-up, dropped
    free_weights()
    PM.dispatch = recording
    try:
        read = _flash_step_counts(tag, {"flash forward": per, "flash backward": per})
        (rp, ro, rm), ref_ms = _timed(lambda: make_train_step(cfg, **kw)(
            params, adamw_init(params), batch))
        read()
        ref_loss = float(rm["loss"])
        whole = list(seen)
        del rp, ro, rm
        free_weights()
        seen.clear()
        mesh = make_host_mesh(2, 2, devices=[torch.device(DEVICE, 0)] * 4)
        ps, opt, _ = _mesh_state(cfg, params, mesh)
        del params
        # one a layer, dp part and tensor shard, each shard's half of the heads
        read = _flash_step_counts(tag, {"flash forward": 4 * per, "flash backward": 4 * per})
        (ps, opt, metrics), ms = _timed(lambda: make_train_step(cfg, mesh=mesh, **kw)(
            ps, opt, batch))
        launched = read()
    finally:
        PM.dispatch = real
    L = cfg.n_layers
    if len(whole) != MESH_ACCUM * L or len(seen) != 2 * MESH_ACCUM * L:
        fail(f"{tag}: {len(whole)} / {len(seen)} dispatches recorded")
    invariant = True
    routed = kept_differ = dropped = kept = 0
    first_layer = None
    for i in range(MESH_ACCUM):
        for l in range(L):
            parts = [seen[(2 * i + j) * L + l] for j in range(2)]
            idx = torch.cat([p[0] for p in parts])
            keep = torch.cat([p[2] for p in parts])
            w_idx, w_cap, w_keep = whole[i * L + l]
            invariant &= all(p[1] == w_cap for p in parts) and torch.equal(
                real(idx, w_cap, cfg.n_experts)[1], keep)
            n_routed = int((idx != w_idx).sum())
            routed += n_routed
            kept_differ += int((keep != w_keep).sum())
            if n_routed and first_layer is None:
                first_layer = l
            dropped += int((~w_keep).sum())
            kept += int(w_keep.sum())
    loss = float(metrics["loss"])
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    total = kept + dropped
    print(f"{tag}: the parts' keep masks bit for bit the microbatch's dispatch of their "
          f"routing: {invariant}; against the unsharded step ({kept} kept, {dropped} dropped of "
          f"{total} assignments over {MESH_ACCUM} microbatches x {L} layers): top-k ids differ "
          f"in {routed} ({100 * routed / total:.3f} %), keep masks in {kept_differ} "
          f"({100 * kept_differ / total:.3f} %), first at layer {first_layer}; loss {loss:.6f} "
          f"against {ref_loss:.6f} (relative {loss_rel:.3g}, limit {MOE_MESH_LOSS_REL:g}); step "
          f"{ms:.1f} ms (the first on the mesh) against the unsharded {ref_ms:.1f} ms; flash launches "
          f"{launched['flash_attention']} / {launched['flash_attention_bwd']} ({smi_line})")
    if not invariant or dropped == 0 or loss_rel > MOE_MESH_LOSS_REL:
        fail(f"{tag}: the split changed the MoE dispatch or the loss")
    del ps, opt, metrics, whole
    seen.clear()
    free_weights()
    paths = {k: {key: n for key, n in v.items()} for k, v in launched.items()}
    return paths, dict(layers=L, kept=kept, dropped=dropped, invariant_bit_for_bit=invariant,
                       routing_differs=routed, keep_differs=kept_differ,
                       first_differing_layer=first_layer, loss_rel=loss_rel, step_ms=ms,
                       unsharded_step_ms=ref_ms)


def phase_compressed_psum(cfg, params, smi_line):
    """(t15) compressed_psum over [cuda:0] x 4 on qwen3-1.7b's largest
    gradient leaf, the embedding's (vocab x d_model float32): the four
    participants are the embedding gradients of four rows of (t13)'s batch,
    each of its own forward and backward. Each element within sum_i
    scale_i / 2 of the float32 sum; bytes on the wire against float32; ms by
    events beside the float32 sum's. Returns numbers."""
    import torch

    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.train.compression import compressed_psum

    tag = "train (t15)"
    batch = _train_batch(cfg, MESH_BATCH, TRAIN_SEQ, 29)
    xs = []
    for r in range(MESH_BATCH):
        _, g = _loss_and_grads(cfg, params, {k: v[r: r + 1] for k, v in batch.items()},
                               block_q=512, remat=False)
        xs.append(g["embed"].float())
        del g
    free_weights()
    got = compressed_psum(xs)
    exact = xs[0] + xs[1] + xs[2] + xs[3]
    scales = sum(float(x.abs().max()) / 127.0 for x in xs)
    err = float((got[0] - exact).abs().max())
    same = all(torch.equal(got[0], g) for g in got[1:])
    n, p = xs[0].numel(), len(xs)
    wire, f32_wire = p * (p - 1) * (n + 4), p * (p - 1) * 4 * n
    ms = device_ms(lambda: compressed_psum(xs), reps=10)
    f32_ms = device_ms(lambda: xs[0] + xs[1] + xs[2] + xs[3], reps=10)
    print(f"{tag}: compressed_psum over 4 participants of {tuple(xs[0].shape)} float32: largest "
          f"error against the float32 sum {err:.4g} (limit sum_i scale_i / 2 = {scales / 2:.4g}); "
          f"every participant's sum the same bits: {same}; {wire / 1e9:.3f} GB on the wire "
          f"(int8 and a scale a participant, to each other one) against {f32_wire / 1e9:.3f} GB "
          f"in float32 ({f32_wire / wire:.2f}x); {ms:.3f} ms by events (one device: no bytes "
          f"cross a link) against {f32_ms:.3f} ms for the plain float32 sum ({smi_line})")
    if err > scales / 2 * (1 + 1e-5) or not same:
        fail(f"{tag}: compressed_psum's error {err} passes sum_i scale_i / 2 = {scales / 2}")
    del xs, got, exact
    free_weights()
    return dict(err=err, limit=scales / 2, wire_bytes=wire, float32_wire_bytes=f32_wire, ms=ms,
                float32_sum_ms=f32_ms)


def phase_train_mesh_restore(smi_line):
    """(t16) at (t4)'s restart size: a 2 x 2-sharded params-and-moments
    tree saved after one mesh step, restored with ``shardings=`` onto the
    2 x 2 mesh and onto 1 x 4, each bit for bit; one more mesh step from
    the 2 x 2 restore bit for bit the uninterrupted run's."""
    import tempfile

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (NamedSharding, P, block_index, param_shardings,
                                             unshard)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.tree import tree_leaves

    tag = "train (t16)"
    cfg = reduced_config(RESTART_ARCH, **RESTART_OVERRIDES)
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    batch = _train_batch(cfg, 4, 256, 41)
    dev0 = torch.device(DEVICE, 0)
    mesh = make_host_mesh(2, 2, devices=[dev0] * 4)
    ps, opt, _ = _mesh_state(cfg, params, mesh)
    del params
    step = make_train_step(cfg, grad_accum=2, remat=False, lr=1e-3, mesh=mesh)
    ps, opt, _ = step(ps, opt, batch)
    tree = {"params": ps, "opt": opt}
    flat = [unshard(x, "cpu") for x in tree_leaves(tree)]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, 1, tree)
        restored = {}
        for grid in ((2, 2), (1, 4)):
            m = make_host_mesh(*grid, devices=[dev0] * 4)
            msh = param_shardings(cfg, m, fsdp=True)
            shardings = {"params": msh, "opt": {"m": msh, "v": msh,
                                                "step": NamedSharding(m, P())}}
            got = restore_checkpoint(tmp, 1, tree, shardings)
            same = all(g.mesh is m and all(
                torch.equal(g.block_at(pos).cpu(), w[block_index(g.shape, g.sharding, pos)])
                for pos in g.positions()) for g, w in zip(tree_leaves(got), flat))
            print(f"{tag}: the 2 x 2-sharded checkpoint restored onto a {grid[0]} x {grid[1]} "
                  f"mesh: every block bit for bit the saved leaf's slice: {same}")
            ok &= same
            restored[grid] = got
    p1, o1, _ = step(ps, opt, batch)
    r = restored[(2, 2)]
    p2, o2, _ = step(r["params"], r["opt"], batch)
    again = all(torch.equal(a.block_at(pos), b.block_at(pos))
                for a, b in zip(tree_leaves({"p": p1, "o": o1}), tree_leaves({"p": p2, "o": o2}))
                for pos in a.positions())
    print(f"{tag}: {cfg.name} ({cfg.dtype}, {cfg.n_layers} layers, d_model {cfg.d_model}): one "
          f"more mesh step from the restore bit for bit the uninterrupted run's: {again} "
          f"({smi_line})")
    if not (ok and again):
        fail(f"{tag}: the sharded restore is not bit for bit")
    free_weights()
    return dict(restore_bit_for_bit=ok, step_after_restore_bit_for_bit=again)


def _serve_tokens(cfg, b, s, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)).to(DEVICE)


def _serve_run(cfg, params, tokens, feed=None, mesh=None):
    """Prefill ``tokens`` (b, s) and SERVE_MESH_DECODE decode steps,
    unsharded or over ``mesh`` (``params`` laid out on it), each input laid
    out as its spec says before its call's events. ``feed``: the decode
    tokens (teacher forcing); None: greedy, the tokens picked returned.
    Returns (the logits of each call, the state, the tokens fed, prefill ms,
    [ms a decode step]) by CUDA events."""
    import torch

    from repro_torch.launch.sharding import batch_specs, serve_state_shardings, shard
    from repro_torch.launch.specs import decode_token_tree
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    state = T.init_serve_state(cfg, b, s + SERVE_MESH_DECODE, device=DEVICE)
    batch, put = {"tokens": tokens}, (lambda t: t)
    if mesh is not None:
        ssh = serve_state_shardings(cfg, mesh, b)
        state = {k: v if k == "length" else shard(v, ssh[k]) for k, v in state.items()}
        batch = {"tokens": shard(tokens, batch_specs(cfg, mesh, b, s, training=False)["tokens"])}
        tsh = decode_token_tree(cfg, mesh, b).sharding
        put = lambda t: shard(t, tsh)  # noqa: E731
    prefill, decode = make_prefill_step(cfg, mesh=mesh), make_decode_step(cfg, mesh=mesh)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * (SERVE_MESH_DECODE + 1))]
    ev[0].record()
    logits, state = prefill(params, batch, state)
    ev[1].record()
    outs, fed = [logits], []
    for i in range(SERVE_MESH_DECODE):
        tok = logits.argmax(-1).to(torch.int32) if feed is None else feed[i]
        fed.append(tok)
        x = put(tok)
        ev[2 * i + 2].record()
        logits, state = decode(params, x, state)
        ev[2 * i + 3].record()
        outs.append(logits)
    torch.cuda.synchronize()
    ms = [ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(SERVE_MESH_DECODE + 1)]
    return outs, state, fed, ms[0], ms[1:]


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _serve_mesh_hold(tag, got, want, got_state, want_state, floor, exact: bool,
                     steps: int = SERVE_MESH_DECODE) -> dict:
    """The mesh run's logits and state against the unsharded run's (both
    whole, the state's blocks gathered): bit for bit where ``exact``, else
    within SERVE_MESH_FLOOR_X x ``floor`` (the unsharded run's relative L2
    from float32: {"logits": x, leaf: x}; None where ``exact`` needs none),
    and argmax equal in every row whose unsharded top-2 margin exceeds 4x
    its largest logit difference."""
    import torch

    from repro_torch.launch.sharding import unshard

    worst, bitwise, flips, sure_rows = 0.0, True, 0, 0
    for g, w in zip(got, want):
        bitwise &= torch.equal(g, w)
        worst = max(worst, _rel_l2(g, w))
        diff = (g - w).abs().amax(-1)
        top2 = w.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 4 * diff
        sure_rows += int(sure.sum())
        flips += int(((g.argmax(-1) != w.argmax(-1)) & sure).sum())
    rel = {"logits": worst}
    for name, st in got_state.items():
        if name == "length":
            continue
        whole = unshard(st, DEVICE)
        bitwise &= torch.equal(whole, want_state[name])
        rel[name] = _rel_l2(whole, want_state[name])
        del whole
    print(f"{tag}: against the unsharded step, relative L2 (the largest over the prefill and "
          f"{steps} decode steps) {_fmt(rel)}, the unsharded step's from float32 "
          + (f"{_fmt(floor)} (limit {SERVE_MESH_FLOOR_X:g}x it)" if floor else "not run")
          + f"; argmax flips {flips} of {sure_rows} rows beyond 4x their difference; bit for "
          f"bit: {bitwise}")
    if exact and not bitwise:
        fail(f"{tag}: not bit for bit the unsharded step")
    if flips or (floor and any(rel[k] > SERVE_MESH_FLOOR_X * floor[k] for k in rel)):
        fail(f"{tag}: the mesh steps disagree with the unsharded steps")
    return dict(rel_l2=rel, bf16_floor=floor, argmax_flips=flips, sure_rows=sure_rows,
                bit_for_bit=bitwise)


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in d.items())


def _serve_reference(cfg, params, params32, b, s, parts, seed):
    """The unsharded steps over ``parts`` row blocks of a seeded (b, s)
    prompt, greedy, then a float32 run (``params32``) of the whole batch on
    the same tokens; returns (tokens, the decode tokens, logits and state of
    the blocks joined by rows, the bfloat16 floor {"logits": x, leaf: x},
    prefill ms, median decode ms)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    tokens = _serve_tokens(cfg, b, s, seed)
    r = b // parts
    # a warm-up prefill at the shape, dropped: the timed runs start warm
    make_prefill_step(cfg)(params, {"tokens": tokens[:r]}, T.init_serve_state(cfg, r, s, DEVICE))
    runs = [_serve_run(cfg, params, tokens[j * r: (j + 1) * r]) for j in range(parts)]
    logits = [torch.cat([run[0][i] for run in runs]) for i in range(SERVE_MESH_DECODE + 1)]
    state = {k: torch.cat([run[1][k] for run in runs], dim=1)
             for k in runs[0][1] if k != "length"}
    feed = [torch.cat([run[2][i] for run in runs]) for i in range(SERVE_MESH_DECODE)]
    ms = (sum(run[3] for run in runs),
          statistics.median(sum(run[4][i] for run in runs) for i in range(SERVE_MESH_DECODE)))
    del runs
    f_logits, f_state, _, _, _ = _serve_run(dataclasses.replace(cfg, dtype="float32"), params32,
                                            tokens, feed)
    floor = {"logits": max(_rel_l2(a, b) for a, b in zip(logits, f_logits))}
    floor.update({k: _rel_l2(state[k], f_state[k]) for k in state})
    return (tokens, feed, logits, state, floor) + ms


def phase_serve_mesh(cfg, params, smi_line, cases, tag="serve (v)") -> tuple:
    """(v) ``cfg`` served over meshes of the card (each position on cuda:0):
    for each (data, model, batch, prompt) of ``cases``, the unsharded
    prefill and SERVE_MESH_DECODE greedy decode steps (over each dp shard's
    rows where the batch splits), then the mesh steps on params laid out by
    param_shardings (fsdp) teacher-forced on the same tokens, held by
    ``_serve_mesh_hold`` (bit for bit on 1 x 1 and k x 1 meshes); flash
    launches a prefill = layers x tensor shards x dp parts, a state-space
    model's scan launches (chunked a prefill, sequential a decode step) =
    layers x tensor shards x dp parts; no plain version. Prints prefill ms
    and ms a decode step by events, mesh beside unsharded, and the peak
    memory. Returns ({kernel: launches}, numbers)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_shardings, shard_tree

    from repro_torch.tree import tree_map

    ssm = cfg.family in ("ssm", "hybrid")
    ops = {"flash_attention": fa} | ({"selective_scan": ss} if ssm else {})
    launched = {name: {"launches": 0} for name in ops}
    numbers, dev0 = {}, torch.device(DEVICE, 0)
    refs = {}
    params32 = tree_map(lambda x: x.float(), params)
    for b, s, parts in dict.fromkeys((b, s, d if b >= 16 else 1) for d, _, b, s in cases):
        refs[b, s, parts] = _serve_reference(cfg, params, params32, b, s, parts, 50 + b)
    del params32
    for data, model, b, s in cases:
        case = f"{data} x {model}, {b} x {s}"
        parts = data if b >= 16 else 1
        tokens, feed, want, want_state, floor, ref_prefill, ref_decode = refs[b, s, parts]
        mesh = make_host_mesh(data, model, devices=[dev0] * (data * model))
        ps = shard_tree(params, param_shardings(cfg, mesh, fsdp=True))
        free_weights()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*ops.values())
        with plain_versions_counted(ops) as plain_calls:
            got, state, _, prefill_ms, decode_ms = _serve_run(cfg, ps, tokens, feed, mesh)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_att = sum(1 for t in range(model) if -(-cfg.n_heads // model) * t < cfg.n_heads)
        want_fa = cfg.n_layers * n_att * parts
        want_ss = cfg.n_layers * model * parts if ssm else 0
        if plain_calls or fa.launches != want_fa:
            fail(f"{tag} {case}: flash launches {fa.launches} (expected {want_fa}), plain "
                 f"versions {plain_calls}")
        if ssm and (ss.launches_by_variant["chunked"] != want_ss
                    or ss.launches_by_variant["sequential"] != want_ss * SERVE_MESH_DECODE):
            fail(f"{tag} {case}: scan launches {counts(ss)}, expected {want_ss} chunked and "
                 f"{want_ss * SERVE_MESH_DECODE} sequential")
        for name, mod in ops.items():
            for key, n in counts(mod).items():
                launched[name][key] = launched[name].get(key, 0) + n
        hold = _serve_mesh_hold(f"{tag} {cfg.name} {case}", got, want, state, want_state,
                                floor, exact=model == 1)
        dec = statistics.median(decode_ms)
        print(f"{tag}: {cfg.name} on a {case} mesh: prefill {prefill_ms:.2f} ms (unsharded "
              f"{ref_prefill:.2f}), a decode step {dec:.2f} ms (median of {SERVE_MESH_DECODE}; "
              f"unsharded {ref_decode:.2f}), flash {fa.launches} launches a prefill"
              + (f", scan {ss.launches_by_variant['chunked']} chunked + "
                 f"{ss.launches_by_variant['sequential']} sequential" if ssm else "")
              + f", peak {peak:.1f} GiB ({smi_line})")
        numbers[case] = dict(prefill_ms=prefill_ms, unsharded_prefill_ms=ref_prefill,
                             decode_ms=dec, unsharded_decode_ms=ref_decode, peak_gib=peak,
                             flash_launches=fa.launches, **hold)
        del ps, state, got
        free_weights()
    return launched, numbers


def _summaries(kst):
    """Each chunk's mean key (L, b, S / c, n_kv, d) of the cache ``kst``
    (L, b, S, n_kv, d): a tensor, or a ShardedTensor whose blocks each give
    their own chunks' means, laid out on its spec."""
    import numpy as np

    from repro_torch.launch.sharding import ShardedTensor

    c = SPARSE_MESH_CHUNK

    def means(k):
        L, b, s, n, d = k.shape
        return k.view(L, b, s // c, c, n, d).mean(dim=3)

    if not isinstance(kst, ShardedTensor):
        return means(kst)
    blocks = np.empty(kst.blocks.shape, dtype=object)
    for pos in kst.positions():
        blocks[pos] = means(kst.block_at(pos))
    L, b, s, n, d = kst.shape
    return ShardedTensor((L, b, s // c, n, d), kst.dtype, kst.sharding, blocks)


def _sparse_run(cfg, params, tokens, cap, cached, feed=None, mesh=None):
    """Prefill ``tokens`` (b, s) into a cache of ``cap`` positions, then
    SPARSE_MESH_STEPS sparse decode steps (SPARSE_MESH_CHUNK,
    SPARSE_MESH_BUDGET), unsharded or over ``mesh`` (``params`` laid out on
    it); ``cached``: the chunk summaries built from the prefilled cache.
    ``feed``: the decode tokens; None: greedy. Returns (the prefill's and
    each step's logits, the state, the tokens fed, [ms a step] by CUDA
    events)."""
    import torch

    from repro_torch.launch.sharding import batch_specs, serve_state_shardings, shard
    from repro_torch.launch.specs import decode_token_tree
    from repro_torch.launch.steps import make_prefill_step, make_sparse_decode_step
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    state = T.init_serve_state(cfg, b, cap, device=DEVICE)
    batch, put = {"tokens": tokens}, (lambda t: t)
    if mesh is not None:
        ssh = serve_state_shardings(cfg, mesh, b)
        state = {k: v if k == "length" else shard(v, ssh[k]) for k, v in state.items()}
        batch = {"tokens": shard(tokens, batch_specs(cfg, mesh, b, s, training=False)["tokens"])}
        tsh = decode_token_tree(cfg, mesh, b).sharding
        put = lambda t: shard(t, tsh)  # noqa: E731
    logits, state = make_prefill_step(cfg, mesh=mesh)(params, batch, state)
    if cached:
        state["kmean"] = _summaries(state["k"])
    step = make_sparse_decode_step(cfg, chunk_tokens=SPARSE_MESH_CHUNK, budget=SPARSE_MESH_BUDGET,
                                   cached_summaries=cached, mesh=mesh)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * SPARSE_MESH_STEPS)]
    outs, fed = [logits], []
    for i in range(SPARSE_MESH_STEPS):
        tok = logits.argmax(-1).to(torch.int32) if feed is None else feed[i]
        fed.append(tok)
        x = put(tok)
        ev[2 * i].record()
        logits, state = step(params, x, state)
        ev[2 * i + 1].record()
        outs.append(logits)
    torch.cuda.synchronize()
    return outs, state, fed, [ev[2 * i].elapsed_time(ev[2 * i + 1])
                              for i in range(SPARSE_MESH_STEPS)]


@contextlib.contextmanager
def _picks_recorded():
    """Every pick ``steps.top_chunks`` returns while entered, in call
    order."""
    from repro_torch.launch import steps

    calls, real = [], steps.top_chunks

    def recording(scores, k):
        out = real(scores, k)
        calls.append(out)
        return out

    steps.top_chunks = recording
    try:
        yield calls
    finally:
        steps.top_chunks = real


def _seq_blocks(cfg, mesh, b) -> int:
    """The number of blocks serve_state_shardings splits the cache's
    sequence into on ``mesh`` at batch ``b``."""
    import numpy as np

    from repro_torch.launch.sharding import block_index, serve_state_shardings

    sh = serve_state_shardings(cfg, mesh, b)["k"]
    shape = (cfg.n_layers, b, 1 << 20, cfg.n_kv_heads, cfg.d_head)
    return len({block_index(shape, sh, pos)[2].start
                for pos in np.ndindex(*mesh.devices.shape)})


def _picks_share(got, want, parts: int, b: int) -> int:
    """How many (step, layer, row) selections of the mesh run's picks
    ``got`` (step by step, its dp parts in turn) equal, as sets, those of
    the unsharded runs ``want`` (one run a dp part, in turn). Returns
    (equal, all)."""
    import torch

    n = len(want) // parts  # a run's calls: steps x layers
    L = n // SPARSE_MESH_STEPS
    ref_by = [torch.cat([want[j * n + i] for j in range(parts)]) for i in range(n)]
    got_by = [torch.cat([got[(i // L * parts + j) * L + i % L] for j in range(parts)])
              for i in range(n)]
    return sum(int((g.sort(dim=1).values == w.sort(dim=1).values).all(dim=1).sum())
               for g, w in zip(got_by, ref_by)), n * b


def phase_serve_mesh_sparse(cfg, params, smi_line, dense) -> tuple:
    """(vs) ContiguousKV's sparse decode over meshes of the card, on (v)'s
    ``cfg`` and ``params``: for each (data, model, batch, prompt) of
    SPARSE_MESH_CASES, without and with cached summaries, the unsharded
    prefill and SPARSE_MESH_STEPS greedy sparse steps (over each dp shard's
    rows where the batch splits), then the mesh prefill and steps on params
    laid out by param_shardings, teacher-forced on the same tokens, held by
    ``_serve_mesh_hold`` (bit for bit on k x 1 meshes; elsewhere against a
    float32 unsharded run's floor), the share of (step, layer, row) picks
    (as sets) equal to the unsharded step's, flash launches = layers x
    tensor shards x dp parts, no plain version. ``dense``: (v)'s numbers by
    case, whose decode ms print beside. Returns (flash's launches in the
    mesh runs, in all and by variant, numbers)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_shardings, shard_tree
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    launched, numbers, dev0 = {"launches": 0}, {}, torch.device(DEVICE, 0)
    tag, L, c = "serve (vs)", cfg.n_layers, SPARSE_MESH_CHUNK
    params32 = None
    for data, model, b, s in SPARSE_MESH_CASES:
        mesh = make_host_mesh(data, model, devices=[dev0] * (data * model))
        blocks = _seq_blocks(cfg, mesh, b)
        cap = -(-(s + SPARSE_MESH_STEPS) // (blocks * c)) * blocks * c
        parts = data if b >= 16 else 1
        r = b // parts
        tokens = _serve_tokens(cfg, b, s, 70 + b)
        ps = shard_tree(params, param_shardings(cfg, mesh, fsdp=True))
        for cached in (False, True):
            case = f"{data} x {model}, {b} x {s}" + (", cached summaries" if cached else "")
            with _picks_recorded() as ref_picks:
                runs = [_sparse_run(cfg, params, tokens[j * r: (j + 1) * r], cap, cached)
                        for j in range(parts)]
            want = [torch.cat([run[0][i] for run in runs]) for i in range(SPARSE_MESH_STEPS + 1)]
            want_state = {k: torch.cat([run[1][k] for run in runs], dim=1)
                          for k in runs[0][1] if k != "length"}
            feed = [torch.cat([run[2][i] for run in runs]) for i in range(SPARSE_MESH_STEPS)]
            ref_ms = statistics.median(sum(run[3][i] for run in runs)
                                       for i in range(SPARSE_MESH_STEPS))
            del runs
            floor, cfg32 = None, dataclasses.replace(cfg, dtype="float32")
            if model > 1:  # the bfloat16 floor from a float32 run on the same tokens
                if params32 is None:
                    params32 = tree_map(lambda x: x.float(), params)
                with _picks_recorded() as f_picks:
                    f_logits, f_state, _, _ = _sparse_run(cfg32, params32, tokens, cap, cached,
                                                          feed)
                floor = {"logits": max(_rel_l2(a, b_) for a, b_ in zip(want, f_logits))}
                floor.update({k: _rel_l2(want_state[k], f_state[k]) for k in want_state})
                del f_state
            free_weights()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(fa)
            with plain_versions_counted({"flash_attention": fa}) as plain_calls, \
                    _picks_recorded() as got_picks:
                got, state, _, ms = _sparse_run(cfg, ps, tokens, cap, cached, feed, mesh)
            peak = torch.cuda.max_memory_allocated() / 2**30
            n_att = sum(1 for t in range(model) if -(-cfg.n_heads // model) * t < cfg.n_heads)
            want_fa = L * n_att * parts
            if plain_calls or fa.launches != want_fa:
                fail(f"{tag} {case}: flash launches {fa.launches} (expected {want_fa}), plain "
                     f"versions {plain_calls}")
            for key, n in counts(fa).items():
                launched[key] = launched.get(key, 0) + n
            same, total = _picks_share(got_picks, ref_picks, parts, b)
            share = same / total
            f32 = {}
            if model > 1:  # the mesh in float32: its picks against the float32 step's
                ps32 = shard_tree(params32, param_shardings(cfg32, mesh, fsdp=True))
                reset_counts(fa)
                with plain_versions_counted({"flash_attention": fa}) as plain_calls, \
                        _picks_recorded() as m_picks:
                    m_logits, _, _, _ = _sparse_run(cfg32, ps32, tokens, cap, cached, feed,
                                                    mesh)
                del ps32
                if plain_calls or fa.launches != want_fa:
                    fail(f"{tag} {case} float32: flash launches {fa.launches} (expected "
                         f"{want_fa}), plain versions {plain_calls}")
                for key, n in counts(fa).items():
                    launched[key] = launched.get(key, 0) + n
                f_same, _ = _picks_share(m_picks, f_picks, parts, b)
                f32 = dict(picks_equal_f32=f_same, picks_share_f32=f_same / total,
                           rel_l2_f32=max(_rel_l2(a, b_) for a, b_ in zip(m_logits, f_logits)))
                print(f"{tag}: {cfg.name} on a {case} mesh in float32: picks equal to the "
                      f"unsharded float32 step's in {f_same} of {total} selections "
                      f"({f32['picks_share_f32']:.4f}; limit {SPARSE_MESH_F32_PICKS}), logits "
                      f"{f32['rel_l2_f32']:.3g} from it (relative L2, the largest over the "
                      f"prefill and {SPARSE_MESH_STEPS} steps)")
                if f32["picks_share_f32"] < SPARSE_MESH_F32_PICKS:
                    fail(f"{tag} {case}: the float32 mesh picks other chunks than the "
                         f"float32 unsharded step")
                del m_logits, f_logits
            hold = _serve_mesh_hold(f"{tag} {cfg.name} {case}", got, want, state, want_state,
                                    floor, exact=model == 1, steps=SPARSE_MESH_STEPS)
            step_ms = statistics.median(ms)
            dense_key = f"{data} x {model}, {b} x {s}"
            dense_ms = dense.get(dense_key, {}).get("decode_ms")
            print(f"{tag}: {cfg.name} on a {case} mesh (capacity {cap}, "
                  f"{max(1, int(SPARSE_MESH_BUDGET * (cap // c)))} of {cap // c} chunks a "
                  f"layer): a sparse step {step_ms:.2f} ms (median of {SPARSE_MESH_STEPS}; "
                  f"unsharded {ref_ms:.2f}; (v)'s dense mesh decode step "
                  + (f"{dense_ms:.2f} ms" if dense_ms is not None else "not run") + "), picks "
                  f"equal to the unsharded step's in {same} of {total} (step, layer, row) "
                  f"selections ({share:.4f}), flash {fa.launches} launches, peak {peak:.1f} "
                  f"GiB ({smi_line})")
            numbers[case] = dict(step_ms=step_ms, step_ms_all=ms, unsharded_step_ms=ref_ms,
                                 dense_mesh_decode_ms=dense_ms, capacity=cap, peak_gib=peak,
                                 picks_equal=same, picks=total, picks_share=share,
                                 flash_launches=want_fa, **f32, **hold)
            del got, state, want, want_state, feed
            free_weights()
        del ps
        free_weights()
    del params32
    free_weights()
    numbers["seconds"] = time.perf_counter() - t0
    print(f"{tag}: took {numbers['seconds']:.1f} s")
    return launched, numbers


def phase_serve_mesh_models(cfg, params, smi_line, extra=()):
    """(v): qwen3-1.7b (``params``) over SERVE_MESH_CASES and ``extra``,
    its sparse decode over SPARSE_MESH_CASES (vs),
    then full-width hymba-1.5b from a seeded init over SERVE_MESH_HYBRID (its
    heads and kv heads do not divide 2: the fallback gathers and the ceil
    split; 1600 of its 3200 channels a shard). Returns ({kernel: {path:
    launches}}, numbers)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    q_launched, numbers = phase_serve_mesh(cfg, params, smi_line, SERVE_MESH_CASES + extra)
    s_launched, numbers["sparse (vs)"] = phase_serve_mesh_sparse(cfg, params, smi_line,
                                                                 dict(numbers))
    hcfg = get_config(SSM_TRAIN_NAME)
    hparams = _init_weights("serve (v)", hcfg)
    h_launched, numbers[hcfg.name] = phase_serve_mesh(hcfg, hparams, smi_line,
                                                      SERVE_MESH_HYBRID)
    del hparams
    free_weights()
    paths = {"flash_attention": {
        f"{cfg.name} served over meshes of the card (v)": q_launched["flash_attention"],
        f"{cfg.name} sparse decode over meshes of the card, the mesh prefills (vs)": s_launched,
        f"{hcfg.name} served over a 1 x 2 mesh (v)": h_launched["flash_attention"]},
        "selective_scan": {f"{hcfg.name} served over a 1 x 2 mesh (v)":
                           h_launched["selective_scan"]}}
    numbers["seconds"] = time.perf_counter() - t0
    print(f"serve (v): took {numbers['seconds']:.1f} s")
    return paths, numbers


def phase_train_mesh(smi_line):
    """(t13)-(t16): training over a mesh of the card, then (v), serving over
    one, on (t13)'s weights. Returns ({kernel: {path: launches}}, numbers,
    (v)'s ({kernel: {path: launches}}, numbers))."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_NAME)
    params = _init_weights("train (t13)", cfg)
    q_paths, numbers = phase_train_mesh_qwen(cfg, params, smi_line)
    numbers["compressed_psum"] = phase_compressed_psum(cfg, params, smi_line)
    serve = phase_serve_mesh_models(cfg, params, smi_line)
    del params
    free_weights()
    m_paths, numbers["granite"] = phase_train_mesh_moe(smi_line)
    numbers["restore"] = phase_train_mesh_restore(smi_line)
    paths = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        paths[name] = {
            f"qwen3-1.7b {MESH_STEPS} mesh train steps (2 x 2) and one (2 x 1)": q_paths[name],
            f"{MOE_NAME} ({MOE_MESH_LAYERS} layers) one mesh train step (2 x 2)": m_paths[name]}
    numbers["seconds"] = time.perf_counter() - t_phase
    print(f"train: (t13)-(t16) and (v) took {numbers['seconds']:.1f} s")
    return paths, numbers, serve


def phase_train(smi_line):
    """Phase t: (t1)-(t4) and (u) on full-width qwen3-1.7b, then (t5)-(t8)
    on the state-space models, then (t9)-(t12) on gemma3-4b,
    granite-moe-3b-a800m and musicgen-large, then (t13)-(t16), training
    over a mesh. Returns ({kernel: {path: launches}}, the two backward
    kernels' rows, {kernel: its hold at qwen3-1.7b's shapes})."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_NAME)
    kern = phase_train_kernel(cfg, smi_line)
    params, launches, step = phase_train_step(cfg, smi_line)
    roof_paths, roof = phase_train_roofline(cfg, params, step["warm_step_ms"], smi_line)
    paths, held = phase_train_serve(cfg, params, smi_line)
    del params
    free_weights()
    agree = phase_train_agree(cfg, smi_line)
    phase_train_restart(smi_line)
    ssm_paths, scan_row, ssm_flash_bwd = phase_train_ssm(smi_line)
    for name, by_path in ssm_paths.items():
        paths.setdefault(name, {}).update(by_path)
    fam_paths, fam_steps, swa_agree = phase_train_families(smi_line)
    mesh_paths, mesh_numbers, (serve_paths, serve_numbers) = phase_train_mesh(smi_line)
    for name, by_path in serve_paths.items():
        paths.setdefault(name, {}).update(by_path)
    paths.setdefault("flash_attention", {})[
        f"qwen3-1.7b {TRAIN_STEPS} train steps (forward)"] = launches["flash_attention"]
    for path, by_kernel in fam_paths.items():
        paths["flash_attention"][f"{path} (forward)"] = by_kernel["flash_attention"]
    paths["flash_attention"].update({f"{path} (forward)": n
                                     for path, n in mesh_paths["flash_attention"].items()})
    paths["flash_attention"].update(roof_paths["flash_attention"])
    bwd_paths = {f"qwen3-1.7b {TRAIN_STEPS} train steps": launches["flash_attention_bwd"],
                 **roof_paths["flash_attention_bwd"],
                 **ssm_flash_bwd,
                 **{path: by_kernel["flash_attention_bwd"]
                    for path, by_kernel in fam_paths.items()},
                 **mesh_paths["flash_attention_bwd"]}
    by_variant = {}
    for by_path in bwd_paths.values():
        for k, n in by_path.items():
            if k != "launches":
                by_variant[k] = by_variant.get(k, 0) + n
    r = kern["main"]
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
           "launches": sum(n["launches"] for n in bwd_paths.values()),
           "launches_by_path": bwd_paths, "launches_by_variant": by_variant,
           "variant": r["variant"], "lse_err": r["lse_err"],
           "launches_per_training_step": TRAIN_ACCUM * cfg.n_layers,
           "max_abs_err": r["err"], "errs": r["errs"], "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound"]["tensor_core"][0], "bound_by": r["bound"]["tensor_core"][1],
           "bound_term": r["bound"]["tensor_core"][2],
           "cuda_core_bound_ms": r["bound"]["cuda_core"][0],
           "cuda_core_bound_by": r["bound"]["cuda_core"][1],
           "design_bound_ms": r["design_bound"]["tensor_core"][0],
           "design_products": r["products"],
           "library_ms": r["library_ms"], "host_ms": r["host_ms"],
           "train_step": step, "dry_run": roof, "agreement": agree,
           "train_step_families": fam_steps, "agreement_gemma3_4b": swa_agree,
           "train_over_mesh": mesh_numbers}

    def shape_entry(x):
        return {"ms": x["ms"], "library_ms": x["library_ms"],
                "library_refused": x["library_refused"], "plain_ms": x["plain_ms"],
                "host_ms": x["host_ms"], "bound_ms": x["bound"]["tensor_core"][0],
                "bound_by": x["bound"]["tensor_core"][1],
                "cuda_core_bound_ms": x["bound"]["cuda_core"][0], "max_abs_err": x["err"],
                "errs": x["errs"], "lse_err": x["lse_err"], "variant": x["variant"],
                "design_bound_ms": x["design_bound"]["tensor_core"][0],
                "design_products": x["products"]}

    for label in ("window_1024", "float32_tiny"):
        row[label] = shape_entry(kern[label])
    # gemma3-4b's d 256 (the wgmma variant) and hymba-1.5b's d 64 shapes,
    # with the launches the training runs made at each
    d256_paths = {p: n for p, n in bwd_paths.items() if p.startswith(SWA_NAME)}
    row["head_dim_256"] = {**shape_entry(kern["gemma_d256"]),
                           "window_1024": shape_entry(kern["gemma_d256_window_1024"]),
                           "launches": sum(n["launches"] for n in d256_paths.values()),
                           "launches_by_path": d256_paths,
                           "ptxas": kern["d256_ptxas"]}
    row["hymba_d64"] = {**shape_entry(kern["hymba_d64"]),
                        "launches": sum(n["launches"] for p, n in bwd_paths.items()
                                        if p.startswith(SSM_TRAIN_NAME))}
    if row["launches"] < 1 or set(by_variant) != {"wgmma"}:
        fail(f"flash_attention_bwd on the training paths: {by_variant}")
    held["flash_attention"] = {"err": r["forward_err"]}
    held["serve_mesh"] = serve_numbers
    return paths, [row, scan_row], held


SIM_ROUND = 9  # the golden files' resolution (tests/test_golden_trace.py)
SIM_HEADLINE_PREFIX = 6000  # tests/test_system.py's headline ordering


def _golden_scenario(mixed: bool):
    """tests/test_golden_trace.py's scenarios through the port's sim mode:
    2 requests at concurrency 2 with 2 decode tokens, or chunked prefill
    mixed into decode with one forced SLO preemption and swap. Returns the
    fixture's fields at its rounding."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.backends import SimCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.core.session import SyntheticWorkload, build_sim_session
    from repro_torch.serving import Request, Scheduler
    from repro_torch.storage.timing import ChannelSim, DeviceModel

    cfg = get_config("qwen2.5-7b")
    ex = ChannelSim(DeviceModel())
    eng = ContiguousKVEngine(build_sim_session(cfg, 512),
                             SimCompute(cfg, SyntheticWorkload(512, cfg.n_layers, seed=3)), ex,
                             budget=0.25, device_cap=64, host_cap=128,
                             prefill_chunk_tokens=16 if mixed else None)
    sfx = lambda rid: np.zeros(32, np.int64) + rid  # noqa: E731
    if mixed:
        reqs = [Request(request_id=r, suffix=sfx(r), arrival=0.0, decode_tokens=8)
                for r in range(3)]
        reqs.append(Request(request_id=3, suffix=sfx(3), arrival=0.05, ttft_target=1e-3))
        sched = Scheduler(eng, policy="slo_aware", max_concurrency=3, max_batch_tokens=64,
                          preempt=True, swap_on_preempt=True, prefill_estimate=10.0)
    else:
        reqs = [Request(request_id=r, suffix=sfx(r), arrival=0.0, decode_tokens=2)
                for r in range(2)]
        sched = Scheduler(eng, max_concurrency=2)
    done = sched.run(reqs)
    r = lambda x: round(x, SIM_ROUND)  # noqa: E731
    out = {"events": [[r(a), r(b), res, tag] for a, b, res, tag in ex.events],
           "ttft": {str(c.request.request_id): r(c.ttft if mixed else c.trace.ttft)
                    for c in done},
           "finish": {str(c.request.request_id): r(c.finish) for c in done}}
    if mixed:
        out.update(preemptions=sched.preemptions, swaps=sched.swaps)
    return out


def _sim_requests(model, n: int, decode: int, hybrid=None):
    """The e2e phase's request shape priced in sim mode: ContiguousKV on
    Qwen2.5-7B over a PREFIX_LEN-token prefix in CHUNK-token chunks, BUDGET,
    PERIOD / SUBPERIOD, caches of size 0, ``n`` SUFFIX_LEN-token requests in
    a row with ``decode`` tokens each, with the compute-or-load planner
    ``hybrid`` if given. Returns (traces, per-request modelled channel ms by
    event tag, the op sequence of request 0)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.backends import SimCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.core.session import SyntheticWorkload, build_sim_session
    from repro_torch.storage.timing import SimExecutor

    cfg = get_config("qwen2.5-7b")
    ex = SimExecutor(model)
    eng = ContiguousKVEngine(build_sim_session(cfg, PREFIX_LEN, chunk_tokens=CHUNK),
                             SimCompute(cfg, SyntheticWorkload(PREFIX_LEN, cfg.n_layers)), ex,
                             budget=BUDGET, period=PERIOD, subperiod=SUBPERIOD, hybrid=hybrid)
    seq = _record_ops(eng)
    rng = np.random.default_rng(0)
    traces, by_tag = [], []
    for i in range(n):
        first = len(ex.events)
        _, tr = eng.reprefill(rng.integers(0, cfg.vocab_size, SUFFIX_LEN), request_id=i,
                              decode_tokens=decode)
        tags = {}
        for a, b, _, tag in ex.events[first:]:
            tags[tag] = tags.get(tag, 0.0) + (b - a) * 1e3
        traces.append(tr)
        by_tag.append(tags)
    return traces, by_tag, seq


def _mean_tags(dicts) -> dict:
    keys = sorted({k for d in dicts for k in d})
    return {k: round(sum(d.get(k, 0.0) for d in dicts) / len(dicts), 3) for k in keys}


def phase_sim(ref, smi_line):
    """The sim mode on the card's host: no tensor, no launch. (a) both golden
    timelines event for event; (b) the headline ordering's modelled TTFTs;
    (c) the e2e phase's request shape priced by DeviceModel() and by the
    H100 preset beside the e2e phase's measured times; (d) that modelled
    plan against the e2e phase's real one, op for op."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import costmodel as CM
    from repro_torch.core.backends import SimCompute
    from repro_torch.core.engine import (ASH2OEngine, ASLRUEngine, ContiguousKVEngine,
                                         IMPRESSEngine)
    from repro_torch.core.hybrid import HybridPlanner
    from repro_torch.core.session import SyntheticWorkload, build_sim_session
    from repro_torch.storage.timing import DeviceModel, SimExecutor

    t_phase = time.perf_counter()
    # (a) the committed golden timelines, event for event
    for mixed, name in ((False, "ckv_sim_timeline.json"), (True, "ckv_mixed_timeline.json")):
        want = json.loads((ROOT / "tests" / "golden" / name).read_text())
        got = _golden_scenario(mixed)
        if len(got["events"]) != len(want["events"]):
            fail(f"sim (a) {name}: {len(got['events'])} events, the fixture has "
                 f"{len(want['events'])}")
        for i, (g, w) in enumerate(zip(got["events"], want["events"])):
            if g != w:
                fail(f"sim (a) {name}: event {i} is {g}, the fixture's {w}")
        for key in ("ttft", "finish", "preemptions", "swaps"):
            if key in want and got[key] != want[key]:
                fail(f"sim (a) {name}: {key} {got[key]}, the fixture's {want[key]}")
        print(f"sim (a): {name}: {len(got['events'])} events, TTFTs and finishes equal to the "
              f"fixture's at 1e-{SIM_ROUND} s")

    # (b) the headline ordering (tests/test_system.py), modelled
    cfg = get_config("qwen2.5-7b")
    wl = SyntheticWorkload(SIM_HEADLINE_PREFIX, cfg.n_layers, seed=0)
    ttft = {}
    for name, cls, coarse, kw in [("ContiguousKV", ContiguousKVEngine, False, {"budget": 0.05}),
                                  ("AS-LRU", ASLRUEngine, True, {}),
                                  ("AS-H2O-LFU", ASH2OEngine, True, {"budget": 0.05}),
                                  ("IMPRESS", IMPRESSEngine, True, {"budget": 0.05})]:
        eng = cls(build_sim_session(cfg, SIM_HEADLINE_PREFIX, coarse_blocks=coarse),
                  SimCompute(cfg, wl), SimExecutor(DeviceModel()), device_cap=500,
                  host_cap=2000, **kw)
        ttft[name] = eng.reprefill(np.zeros(64, np.int64))[1].ttft
    ckv = ttft["ContiguousKV"]
    if not (ckv < ttft["IMPRESS"] < ttft["AS-H2O-LFU"] and ckv < ttft["AS-LRU"]
            and ttft["IMPRESS"] / ckv > 2.0):
        fail(f"sim (b): the headline ordering does not hold: {ttft}")
    print(f"sim (b): headline ordering at a {SIM_HEADLINE_PREFIX}-token prefix, 5 % budget "
          f"(modelled, DeviceModel()): TTFT "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in ttft.items())
          + "; against ContiguousKV "
          + ", ".join(f"{k} {v / ckv:.2f}x" for k, v in ttft.items() if k != "ContiguousKV"))

    # (c) the e2e phase's request shape, modelled under two device models,
    # beside the card's measured times (a reading: nothing is asserted)
    real = ref["ckv_traces"]
    n, decode = len(real), real[0].n_decoded
    warm = slice(1, n) if n > 1 else slice(0, n)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    waits = lambda ts: _mean_tags([{k: v * 1e3 for k, v in t.stages.items()}  # noqa: E731
                                   for t in ts])
    print(f"sim (c): measured on the card ({smi_line}), the e2e phase's {n} requests "
          f"(warm: 1..{n - 1}): TTFT "
          + ", ".join(f"{t.ttft * 1e3:.2f}" for t in real) + " ms, TPOT "
          + ", ".join(f"{t.tpot * 1e3:.3f}" for t in real) + " ms; warm mean TTFT "
          f"{mean([t.ttft for t in real[warm]]) * 1e3:.2f} ms, TPOT "
          f"{mean([t.tpot for t in real[warm]]) * 1e3:.3f} ms; host ms in compute ops by tag "
          f"(warm mean) {_mean_tags(ref['ckv_busy'][warm])}; waits ms (warm mean) "
          f"{waits(real[warm])}")
    modelled = []
    for label, model in (("DeviceModel() (TPU v5e compute and HBM)", DeviceModel()),
                         ("DeviceModel.h100_sxm5() (data sheet)", DeviceModel.h100_sxm5())):
        traces, by_tag, seq = _sim_requests(model, n, decode)
        modelled.append((traces, seq))
        print(f"sim (c): modelled, {label}: TTFT {traces[0].ttft * 1e3:.3f} ms (request 0), "
              f"{mean([t.ttft for t in traces[warm]]) * 1e3:.3f} ms (warm mean), TPOT "
              f"{mean([t.tpot for t in traces[warm]]) * 1e3:.4f} ms (warm mean); channel busy "
              f"ms by tag (warm mean) {_mean_tags(by_tag[warm])}; waits ms (warm mean) "
              f"{waits(traces[warm])}")
        # compute-or-load's price of that request's prefix (the phase hybrid
        # measures the recompute op itself)
        d = _sim_requests(model, 1, 0, HybridPlanner("force-compute", device_model=model)
                          )[0][0].hybrid_decision
        print(f"sim (c): modelled, {label}: compute-or-load prices recomputing the head "
              f"[0, {d.recompute_tokens}) at t_force_compute {d.t_force_compute * 1e3:.3f} ms "
              f"against t_force_load {d.t_force_load * 1e3:.3f} ms")

    # (d) the modelled plan against the card's: the same ops up to the first
    # token (part A and B, identify, the probe and kv waits), the same
    # periods, chunks selected per period and probe loads; decode differs by
    # design (sim decode drifts its selection and demand-fetches its misses)
    (traces, seq), real_seq = modelled[0], ref["ckv_ops"]
    sim_tr, real_tr = traces[0], real[0]
    prefill = lambda q: q[:next(i for i, op in enumerate(q)  # noqa: E731
                                if op[1].startswith("decode"))]
    ps, pr = prefill(seq), prefill(real_seq)
    if ps != pr:
        at = next((i for i, (a, b) in enumerate(zip(ps, pr)) if a != b), min(len(ps), len(pr)))
        fail(f"sim (d): the modelled prefill ops differ from the card's at op {at} "
             f"({ps[at:at + 1]} against {pr[at:at + 1]}; {len(ps)} and {len(pr)} ops)")
    shape = lambda t, c: ([len(p) for p in t.selected_per_period],  # noqa: E731
                          t.ssd_bytes_probe // CM.probe_bytes(c, PREFIX_LEN, 1.0),
                          len(t.decode_times))
    got, want = shape(sim_tr, cfg), shape(real_tr, ref["cfg"])
    if got != want:
        fail(f"sim (d): (chunks per period, probe loads, decode steps) {got} against the "
             f"card's {want}")
    kinds = {}
    for op in ps:
        kinds[op[:2]] = kinds.get(op[:2], 0) + 1
    print(f"sim (d): request 0's modelled plan equals the card's op for op up to the first "
          f"token ({len(ps)} ops: " + ", ".join(f"{k} {t} x{c}" for (k, t), c in kinds.items())
          + f"); chunks selected per period {got[0]}, probe loads {got[1]}, decode steps "
          f"{got[2]}; tokens loaded "
          f"{sim_tr.tokens_loaded} modelled against the card's {real_tr.tokens_loaded} "
          f"(the workload model's selections against the model's)")
    print(f"sim: phase took {time.perf_counter() - t_phase:.1f} s")


def phase_laid_out_init(smi_line) -> dict:
    """(w) the laid-out init of full-width qwen3-1.7b on a 2 x 2 mesh of
    the card against init_params + shard_tree, block by block bit for bit;
    both timed, the laid-out one's peak printed. Returns its numbers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (make_host_mesh, peak_memory, reset_peak_memory,
                                         synchronize)
    from repro_torch.launch.sharding import param_shardings, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_flatten_with_path

    cfg = get_config(TRAIN_NAME)
    dev = torch.device(DEVICE, 0)
    mesh = make_host_mesh(2, 2, devices=[dev] * 4)
    sh = param_shardings(cfg, mesh, fsdp=True)
    free_weights()
    reset_peak_memory(mesh)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    got = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, shardings=sh)
    synchronize(mesh)
    laid_s = time.perf_counter() - t0
    peak = max(peak_memory(mesh).values()) - before
    t0 = time.perf_counter()
    want = shard_tree(T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), sh)
    synchronize(mesh)
    plain_s = time.perf_counter() - t0
    n_blocks = total = 0
    for (path, g), (_, w) in zip(tree_flatten_with_path(got), tree_flatten_with_path(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"laid-out init (w): {path} is {g.shape} {g.dtype}, not {w.shape} {w.dtype}")
        for pos in w.positions():
            a, b = g.block_at(pos), w.block_at(pos)
            if a.device != b.device or not torch.equal(a, b):
                fail(f"laid-out init (w): {path} at {pos} differs from shard_tree's block")
            n_blocks += 1
            total += a.numel() * a.element_size()
    print(f"laid-out init (w): {cfg.name} on a 2 x 2 mesh of the card: {n_blocks} blocks, "
          f"{total / 2**30:.2f} GiB, bit for bit init_params + shard_tree; {laid_s:.2f} s laid "
          f"out (peak {peak / 2**30:.2f} GiB above what was held), {plain_s:.2f} s whole then "
          f"sharded ({smi_line})")
    del got, want
    free_weights()
    return dict(blocks=n_blocks, bytes=total, laid_out_s=laid_s, peak_bytes=peak,
                whole_then_shard_s=plain_s)


def time_phases():
    """Make every ``phase_*`` function print its seconds when it returns
    (nested phases too), so a run shows where its time limit goes."""
    g = globals()
    for name in [n for n in g if n.startswith("phase_")]:
        def timed(*a, _f=g[name], _n=name, **kw):
            t0 = time.perf_counter()
            try:
                return _f(*a, **kw)
            finally:
                print(f"time: {_n} {time.perf_counter() - t0:.1f} s")
        g[name] = timed


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

    time_phases()
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
    tp_paths, rows["decode_attention"]["sharded"] = phase_tp(cfg, ctx, smi_line)
    for name, by_path in tp_paths.items():
        paths.setdefault(name, {}).update(by_path)
    rows["chunk_attention"]["serve"] = {k: serve_numbers[k]
                                        for k in ("e", "f", "part_b_batch_hold")}
    hybrid_paths, hybrid_numbers = phase_hybrid(cfg, ctx, smi_line)
    for name, by_path in hybrid_paths.items():
        paths.setdefault(name, {}).update(by_path)
    # the Qwen weights stay for the fleet phase, the other sessions go; the
    # sim phase keeps the e2e requests' traces, compute times and op sequence
    weights = {cfg.name: ctx["params"]}
    sim_ref = {k: ctx[k] for k in ("ckv_traces", "ckv_busy", "ckv_ops")}
    sim_ref["cfg"] = cfg
    del ctx
    torch.cuda.empty_cache()
    rows.update(phase_state_kernels(hcfg, cfg, fcfg))
    rows["flash_attention"]["hybrid"] = hybrid_numbers
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
    # the new families, each model's weights freed before the next loads
    del weights
    free_weights()
    mcfg = dataclasses.replace(get_config(MOE_NAME), n_layers=MOE_SERVE_LAYERS)
    gcfg, acfg = get_config(SWA_NAME), get_config(AUDIO_NAME)
    wide = phase_wide_kernels(gcfg, smi_line)
    for phase, c in ((phase_moe, mcfg), (phase_swa, gcfg), (phase_audio, acfg)):
        new_paths, _ = phase(c, smi_line)
        for name, by_path in new_paths.items():
            paths.setdefault(name, {}).update(by_path)
        free_weights()
    for name, r in wide.items():
        w = {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"]["tensor_core"][0], "bound_by": r["bound"]["tensor_core"][1],
             "library_ms": r.get("library_ms", r.get("sdpa_output_only_ms")),
             "host_ms": r["host_ms"],
             "launches": sum(p["launches"] for k, p in paths[name].items() if "d 256" in k)}
        if "windowed" in r:
            w["window_1024"] = {"ms": r["windowed"]["ms"],
                                "library_ms": r["windowed"]["library_ms"],
                                "plain_ms": r["windowed"]["plain_ms"],
                                "bound_ms": r["windowed"]["bound"]["tensor_core"][0],
                                "max_abs_err": r["windowed"]["err"]}
        if w["launches"] < 1:
            fail(f"{name} never launched at d 256 on gemma3-4b's path")
        rows[name]["head_dim_256"] = w
    train_paths, bwd_rows, train_held = phase_train(smi_line)
    for name, by_path in train_paths.items():
        paths.setdefault(name, {}).update(by_path)
    serve_mesh = train_held.pop("serve_mesh")
    rows["flash_attention"]["serve_mesh"] = serve_mesh
    rows["selective_scan"]["serve_mesh"] = {"hymba-1.5b": serve_mesh["hymba-1.5b"]}
    for name, r in train_held.items():
        rows[name]["qwen3_1_7b"] = {k: (r[k]["tensor_core"][0] if k == "bound" else r[k])
                                    for k in ("err", "ms", "plain_ms", "host_ms", "bound")
                                    if k in r}
    phase_laid_out_init(smi_line)
    phase_sim(sim_ref, smi_line)
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
                    "serve", "decode_batched", "fleet", "hybrid", "head_dim_256",
                    "qwen3_1_7b", "sharded", "serve_mesh"):
            if key in r:
                row[key] = r[key]
        kernels.append(row)
    kernels.extend(bwd_rows)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
