"""Serving driver, real mode: concurrent request streams through the scheduler.

Ingests a shared prefix into a reduced real model once (random weights from
seed 0), then serves a stream of requests concurrently on the card: plans
multiplex over the executor's I/O threads, so one request's chunk reads
overlap another's compute, and concurrent decode steps run as one batched
pass.

  python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --system contiguous_kv --budget 0.25 --requests 8 --concurrency 4

``--device cpu`` runs it on the CPU (the kernels' plain versions).
``--decode-tokens N`` extends every request past the first token, and the
digest adds mean TPOT, inter-token P95 and decode token throughput.
``--ttft-slo S`` attaches a TTFT deadline to every request (pair with
``--policy slo_aware``). ``--preempt`` enables SLO-driven preemption of
decode plans; with ``--swap-on-preempt`` the victim's device-resident pools
move to host memory and back. ``--host-tail-pool`` forces the host-resident
decode pools (a pool upload per step). ``--disaggregate P:D`` hands each
plan's decode phase to one of D decode-worker backends, ``--replicas N`` to
one of N replicas' backends, through the pools' swap round trip.
``--prefill-chunk-tokens C`` splits each layer's part B into ops of C suffix
tokens, and concurrent plans' same-layer final chunks run as one batched
part B (one launch of chunk_attention's indexed form); the digest counts
those batches beside the decode ones.

``--fleet model:count,model:count`` serves a heterogeneous fleet behind the
one Scheduler, e.g. ``--fleet qwen2_5_7b:1,falcon_mamba_7b:1,hymba_1_5b:1``:
one reduced model and backend per tenant, attention-family tenants on the
``--system`` KV engine, ssm/hybrid tenants on ``StateSpaceEngine`` (a
fixed-size recurrent state per request, whose concurrent decode steps run
as one batched step). Every op's weight stream is namespaced per model, so
iterations interleave across families but a batch never amortizes one
model's weights against another's. It does not compose with
``--disaggregate``, ``--replicas`` or ``--tp-decode``.

Not yet in the port, each exiting at once with the slice that brings it:
``--mode sim``, ``--hybrid-reprefill`` other than ``off``, ``--cache-tiers``
and ``--tp-decode``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.serving import (POLICIES, DisaggTopology, ReplicaSet, Request,
                                 Scheduler, summarize)
from repro_torch.serving.tenancy import ENGINE_CLASSES, parse_fleet_spec

# flags of the JAX package's driver that wait for a later slice of the port
DEFERRED = {
    "mode": "--mode sim comes with the port's sim slice",
    "hybrid_reprefill": "--hybrid-reprefill comes with the port's compute-or-load slice",
    "cache_tiers": "--cache-tiers comes with the port's tier store, in its sim slice",
    "tp_decode": "--tp-decode comes with the port's multi-device slice",
}


def _refuse_deferred(args):
    given = {"mode": args.mode != "real",
             "hybrid_reprefill": args.hybrid_reprefill != "off",
             "cache_tiers": args.cache_tiers is not None,
             "tp_decode": args.tp_decode is not None}
    for flag, on in given.items():
        if on:
            raise SystemExit(f"not in the port yet: {DEFERRED[flag]}")


def _print_replica_digest(sched):
    if sched.replicas is None:
        return
    reps = sched.replicas
    admits = "/".join(str(n) for n in sched.replica_admits)
    suffix = (f" x {reps.topology.n_prefill}P:{reps.topology.n_decode}D each"
              if reps.topology is not None else "")
    print(f"replicas={reps.n_replicas}{suffix}: admissions {admits}")


def _print_handoff_digest(sched):
    topo = (sched.replicas.topology if sched.replicas is not None
            else sched.topology)
    if topo is None:
        return
    print(f"disaggregated {topo.n_prefill}P:{topo.n_decode}D: "
          f"handoffs={sched.handoffs} "
          f"kv_bytes={sched.handoff_bytes/1e6:.2f}MB")


def _print_serve_digest(sched, completed, args):
    """The p50/p95, decode and batch digest lines of a served run."""
    s = summarize(completed)
    print(f"concurrency={args.concurrency} policy={args.policy} "
          f"p50={s['p50_ttft']*1e3:.1f}ms p95={s['p95_ttft']*1e3:.1f}ms "
          f"goodput={s['goodput_rps']:.2f} req/s")
    if "mean_tpot" in s:
        print(f"decode: mean TPOT={s['mean_tpot']*1e3:.1f}ms "
              f"ITL p95={s['p95_itl']*1e3:.1f}ms "
              f"{s['decode_tok_rate']:.1f} tok/s")
    for phase, what in (("decode", "batched iterations"),
                        ("prefill", "prefill-chunk batches")):
        sizes = [len(b) for b in sched.real_batch_log if b[0][1] == phase]
        if sizes:
            print(f"{what}: {len(sizes)} "
                  f"(mean b={np.mean(sizes):.2f}, max b={max(sizes)})")
        elif phase == "prefill" and args.prefill_chunk_tokens:
            print(f"{what}: 0")
    if args.preempt:
        pools = "host" if args.host_tail_pool else "device"
        print(f"preemptions={s['preemptions']} swaps={s['swaps']} "
              f"swap_bytes={sched.swap_bytes/1e6:.2f}MB ({pools} pools)")


def _real_main(args):
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import RealCompute
    from repro_torch.core.session import build_real_session
    from repro_torch.data.synthetic import make_task
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.storage.timing import RealExecutor

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch, n_layers=args.n_layers)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    task = make_task(args.dataset, cfg.vocab_size, n_queries=args.requests)
    print(f"ingesting shared prefix: {len(task.prefix)} tokens "
          f"({args.dataset}, {cfg.name})")
    coarse = args.system != "contiguous_kv"
    sess = build_real_session(cfg, params, task.prefix,
                              chunk_tokens=args.chunk_tokens,
                              coarse_blocks=coarse, in_memory=True, device=dev)
    ex = RealExecutor()
    kw = dict(device_cap=64, host_cap=128,
              prefill_chunk_tokens=args.prefill_chunk_tokens,
              device_tail_pool=not args.host_tail_pool)
    if args.system == "contiguous_kv":
        kw.update(budget=args.budget, period=args.period, subperiod=args.subperiod)
    elif args.system != "as_lru":
        kw.update(budget=args.budget)
    eng = ENGINE_CLASSES[args.system](sess, RealCompute(cfg, params, device=dev), ex, **kw)

    topology = None
    if args.disaggregate:
        topology = DisaggTopology.parse(args.disaggregate)
    replicas = None
    if args.replicas:
        n = ReplicaSet.parse(args.replicas).n_replicas
        workers = topology.n_decode if topology is not None else 1
        # every worker backend shares the colocated params: bit-identical
        # logits whichever replica serves the decode phase
        replicas = ReplicaSet(
            topology=topology,
            backends=[[RealCompute(cfg, params, device=dev) for _ in range(workers)]
                      for _ in range(n)])
        split = (f" x {topology.n_prefill}P:{topology.n_decode}D each"
                 if topology is not None else "")
        print(f"replicating: {n} data-parallel replicas{split} "
              f"(pool handoff at decode)")
    elif topology is not None:
        topology.decode_backends = [RealCompute(cfg, params, device=dev)
                                    for _ in range(topology.n_decode)]
        print(f"disaggregating: {topology.n_prefill} prefill / "
              f"{topology.n_decode} decode workers (pool handoff)")

    requests = [Request(request_id=rid, suffix=suffix,
                        decode_tokens=args.decode_tokens,
                        ttft_target=args.ttft_slo)
                for rid, (suffix, _) in enumerate(task.queries)]
    sched = Scheduler(eng, policy=args.policy, max_concurrency=args.concurrency,
                      batch_decode=not args.no_batch_decode,
                      max_batch_tokens=args.max_batch_tokens,
                      preempt=args.preempt,
                      swap_on_preempt=args.swap_on_preempt,
                      prefill_estimate=args.prefill_estimate,
                      topology=topology, replicas=replicas)
    completed = sched.run(requests)
    ex.shutdown()

    correct = 0
    for c in completed:
        rid = c.request.request_id
        _, gold = task.queries[rid]
        pred = int(np.argmax(c.result[0, -1]))
        correct += int(pred == task.label_token(gold))
        tr = c.trace
        dec = (f" tpot={tr.tpot*1e3:6.1f}ms ({tr.n_decoded} tok)"
               if tr.decode_times else "")
        print(f"req {rid:2d}: ttft={c.ttft*1e3:7.1f}ms ssd={tr.ssd_bytes/1e3:8.1f}KB "
              f"amp={tr.read_amplification:5.2f} hits(d/h)={tr.hits_device}/{tr.hits_host}"
              f"{dec}")
    _print_serve_digest(sched, completed, args)
    _print_replica_digest(sched)
    _print_handoff_digest(sched)
    if args.decode_tokens == 0:
        # with decode, c.result is the last token's logits, not the label's
        print(f"label-token accuracy (untrained model => chance-level): "
              f"{correct}/{len(task.queries)}")
    return completed


def _real_fleet_main(args):
    """Real-mode heterogeneous fleet: one reduced real model and backend per
    tenant, every family iteration-batched behind the one wall-clock
    Scheduler."""
    import dataclasses

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import RealCompute, StateCompute
    from repro_torch.core.engine import StateSpaceEngine
    from repro_torch.core.session import build_real_session
    from repro_torch.data.synthetic import make_task
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.storage.timing import RealExecutor

    if args.disaggregate or args.replicas or args.tp_decode is not None:
        raise SystemExit("--fleet in real mode does not compose with "
                         "--disaggregate/--replicas/--tp-decode (per-model "
                         "worker backends are not wired)")
    dev = resolve_device(args.device)
    entries = parse_fleet_spec(args.fleet)
    ex = RealExecutor()
    engines, cfgs = {}, {}
    tenant = 0
    task = None
    for name, count in entries:
        cfg = reduced_config(name)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        if task is None:
            # one synthetic task: every reduced config shares a vocab, so
            # the fleet serves the same prompt and query stream
            task = make_task(args.dataset, cfg.vocab_size, n_queries=args.requests)
            print(f"ingesting shared prefix: {len(task.prefix)} tokens "
                  f"({args.dataset})")
        for _ in range(count):
            tenant += 1
            cfgs[tenant] = cfg
            if cfg.family in T.STATE_FAMILIES:
                engines[tenant] = StateSpaceEngine(
                    cfg, StateCompute(cfg, params, device=dev), ex,
                    prefix_tokens=task.prefix, tenant=tenant,
                    prefill_chunk_tokens=args.prefill_chunk_tokens)
                continue
            coarse = args.system != "contiguous_kv"
            sess = build_real_session(cfg, params, task.prefix,
                                      chunk_tokens=args.chunk_tokens,
                                      coarse_blocks=coarse, in_memory=True, device=dev)
            sess = dataclasses.replace(sess, tenant=tenant)
            kw = dict(device_cap=64, host_cap=128,
                      prefill_chunk_tokens=args.prefill_chunk_tokens,
                      device_tail_pool=not args.host_tail_pool)
            if args.system == "contiguous_kv":
                kw.update(budget=args.budget, period=args.period, subperiod=args.subperiod)
            elif args.system != "as_lru":
                kw.update(budget=args.budget)
            engines[tenant] = ENGINE_CLASSES[args.system](
                sess, RealCompute(cfg, params, device=dev), ex, **kw)
    roster = ", ".join(f"t{t}={c.name}[{c.family}]" for t, c in sorted(cfgs.items()))
    print(f"heterogeneous fleet: {roster}")
    requests = [Request(request_id=rid, suffix=suffix,
                        tenant=1 + rid % len(engines),
                        decode_tokens=args.decode_tokens,
                        ttft_target=args.ttft_slo)
                for rid, (suffix, _) in enumerate(task.queries)]
    sched = Scheduler(engines, policy=args.policy,
                      max_concurrency=args.concurrency,
                      batch_decode=not args.no_batch_decode,
                      max_batch_tokens=args.max_batch_tokens,
                      preempt=args.preempt,
                      swap_on_preempt=args.swap_on_preempt,
                      prefill_estimate=args.prefill_estimate)
    completed = sched.run(requests)
    ex.shutdown()
    for c in completed:
        tr = c.trace
        dec = (f" tpot={tr.tpot*1e3:6.1f}ms ({tr.n_decoded} tok)"
               if tr.decode_times else "")
        print(f"req {c.request.request_id:2d} "
              f"{cfgs[c.request.tenant].name:>24s}: "
              f"ttft={c.ttft*1e3:7.1f}ms{dec}")
    _print_serve_digest(sched, completed, args)
    return completed


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--mode", default="real", choices=("real", "sim"))
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card (default) or cpu")
    p.add_argument("--system", default="contiguous_kv", choices=list(ENGINE_CLASSES))
    p.add_argument("--budget", type=float, default=0.25)
    p.add_argument("--chunk-tokens", type=int, default=16)
    p.add_argument("--period", type=int, default=4)
    p.add_argument("--subperiod", type=int, default=2)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--policy", default="fcfs", choices=list(POLICIES))
    p.add_argument("--decode-tokens", type=int, default=0,
                   help="tokens to generate past the first (decode phase)")
    p.add_argument("--ttft-slo", type=float, default=None,
                   help="per-request TTFT target in seconds (slo_aware policy)")
    p.add_argument("--no-batch-decode", action="store_true",
                   help="run every decode step alone (no batched decode pass)")
    p.add_argument("--hybrid-reprefill", default="off",
                   choices=("off", "auto", "force-compute", "force-load"))
    p.add_argument("--prefill-chunk-tokens", type=int, default=None)
    p.add_argument("--max-batch-tokens", type=int, default=None,
                   help="token budget of one batched decode iteration")
    p.add_argument("--preempt", action="store_true",
                   help="SLO-driven preemption of decode plans")
    p.add_argument("--swap-on-preempt", action="store_true",
                   help="move a preempted plan's device pools to host memory and back")
    p.add_argument("--host-tail-pool", action="store_true",
                   help="host-resident decode pools (a pool upload per step) instead of "
                        "the device-resident default")
    p.add_argument("--prefill-estimate", type=float, default=None,
                   help="floor (seconds) of the projected prefill service time; the "
                        "first-token EWMA raises it")
    p.add_argument("--disaggregate", default=None, metavar="P:D",
                   help="P prefill + D decode workers, the decode phase handed to a "
                        "decode worker's backend through the pools")
    p.add_argument("--replicas", default=None, metavar="N",
                   help="data-parallel serving replicas behind one Scheduler, one "
                        "backend each; composes with --disaggregate")
    p.add_argument("--tp-decode", type=int, default=None, metavar="K")
    p.add_argument("--arch", default="qwen2.5-14b")
    p.add_argument("--dataset", default="rte")
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--cache-tiers", default=None, metavar="HBM:DRAM:SSD")
    p.add_argument("--fleet", default=None, metavar="MODEL:N,MODEL:N",
                   help="heterogeneous fleet: per-model tenant counts (KV engines for "
                        "attention models, StateSpaceEngine for ssm/hybrid) behind one "
                        "Scheduler; overrides --arch")
    args = p.parse_args(argv)
    if args.concurrency < 1:
        p.error("--concurrency must be >= 1")
    _refuse_deferred(args)
    if args.fleet:
        return _real_fleet_main(args)
    return _real_main(args)


if __name__ == "__main__":
    main()
