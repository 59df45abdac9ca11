"""The port's sim-mode Scheduler against the JAX package's, on the CPU.

The discrete-event driver (admission, mixed prefill/decode batches with the
token budget, SLO preemption with swap, the disaggregated handoff priced by
the compute-or-load planner, replicas, heterogeneous fleets) and
``serve --mode sim``: the same scenario through both packages gives the same
channel events, traces, completions and ``summarize`` digest, unrounded,
and the same printed summary. Mirrors the sim cases of the JAX package's
``test_serving_parity.py``, ``test_disagg.py``, ``test_replicas.py`` and
``test_fleet.py``.
"""
import sys

import numpy as np
import pytest

from repro.launch import serve as jax_serve
from repro_torch.launch import serve
from test_torch_sim import JAX, MODEL, PORT, assert_same, cache_digest, plain, trace_digest

SYSTEMS = ("contiguous_kv", "as_lru", "as_h2o_lfu", "impress")
PREFIX, N_REQ = 2048, 3


def _suffix(rid):
    return np.zeros(48, np.int64) + rid % 5


def _engine(P, system, ex, prefill_chunk_tokens=None):
    """test_serving_parity.py's engine: 2048-token prefix, caches 200/800."""
    cfg = P.get_config(MODEL)
    wl = P.SyntheticWorkload(PREFIX, cfg.n_layers, seed=2)
    sess = P.build_sim_session(cfg, PREFIX, coarse_blocks=system != "contiguous_kv")
    kw = dict(device_cap=200, host_cap=800, prefill_chunk_tokens=prefill_chunk_tokens)
    if system == "contiguous_kv":
        kw.update(budget=0.25, period=8, subperiod=4)
    elif system != "as_lru":
        kw.update(budget=0.25)
    return P.ENGINE_CLASSES[system](sess, P.SimCompute(cfg, wl), ex, **kw)


def run_digest(P, sched, ex, done) -> dict:
    """Everything a sim serving run leaves: events, completions, traces, the
    digest and the scheduler's counters and batch logs."""
    caches = {id(e.cache): e.cache for e in sched.engines.values()
              if getattr(e, "cache", None) is not None}
    return {"events": plain(ex.events),
            "done": [(c.request.request_id, c.admitted, c.finish, c.ttft, c.queue_delay,
                      c.preemptions, c.swaps, c.result) for c in done],
            "traces": [trace_digest(c.trace) for c in done],
            "summary": plain(P.summarize(done)),
            "counters": [sched.preemptions, sched.swaps, sched.swap_bytes, sched.handoffs,
                         sched.handoff_bytes, sched.handoff_recomputes,
                         sched.handoff_bytes_avoided, list(sched.replica_admits)],
            "batch_log": list(sched.batch_log), "sim_batch_log": plain(sched.sim_batch_log),
            "caches": [cache_digest(c) for c in caches.values()],
            "free_at": plain(ex.free_at)}


def serve_run(P, system, *, conc=1, policy="fcfs", decode=0, chunk=None, n=N_REQ, **kw):
    ex = P.ChannelSim(P.DeviceModel())
    sched = P.Scheduler(_engine(P, system, ex, chunk), policy=policy, max_concurrency=conc,
                        **kw)
    reqs = [P.Request(request_id=rid, suffix=_suffix(rid), arrival=0.0, decode_tokens=decode)
            for rid in range(n)]
    return run_digest(P, sched, ex, sched.run(reqs))


def serial(P, system, *, decode=0, chunk=None, n=N_REQ):
    """drive_serial over a SimExecutor, one request after the other."""
    ex = P.SimExecutor(P.DeviceModel())
    eng = _engine(P, system, ex, chunk)
    return [trace_digest(eng.reprefill(_suffix(r), request_id=r, decode_tokens=decode)[1])
            for r in range(n)]


# ------------------------------------------------- test_serving_parity's cases
@pytest.mark.parametrize("policy", ["cache_aware", "fcfs", "slo_aware"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_concurrency_one_bit_identical_to_serial(system, policy):
    got = serve_run(PORT, system, policy=policy)
    assert_same(got, serve_run(JAX, system, policy=policy))
    assert [d[0] for d in got["done"]] == list(range(N_REQ))
    assert got["traces"] == serial(PORT, system)


@pytest.mark.parametrize("system", SYSTEMS)
def test_concurrency_one_with_decode_prices_like_serial(system):
    """With 3 decode tokens at concurrency 1 every batch has one member:
    the serial decode timeline."""
    got = serve_run(PORT, system, decode=3, n=2)
    assert_same(got, serve_run(JAX, system, decode=3, n=2))
    assert got["traces"] == serial(PORT, system, decode=3, n=2)


@pytest.mark.parametrize("chunk", [48, 64, 10_000])
@pytest.mark.parametrize("system", SYSTEMS)
def test_chunk_tokens_ge_suffix_is_bit_identical(system, chunk):
    """Chunks of at least the suffix (48 tokens) are the one per-layer op."""
    got = serial(PORT, system, chunk=chunk)
    assert got == serial(JAX, system, chunk=chunk) == serial(PORT, system)


@pytest.mark.parametrize("system", SYSTEMS)
def test_chunked_plans_select_identically(system):
    """Chunks of 16 at concurrency 3 with 4 decode tokens: batched (and for
    ContiguousKV mixed prefill and decode) iterations under a 64-token
    budget, equal to the JAX package's; the selections are the unchunked
    engine's."""
    kw = dict(conc=3, decode=4, chunk=16, max_batch_tokens=64)
    got = serve_run(PORT, system, **kw)
    assert_same(got, serve_run(JAX, system, **kw))
    tags = {tag for *_, tag in got["events"]}
    assert any("[x" in tag for tag in tags)
    assert system != "contiguous_kv" or "compute:mixed[x3]" in tags
    ref = serial(PORT, system, n=1)[0]
    assert got["traces"][0]["selected_per_layer"] == ref["selected_per_layer"]


def _preempt(P, preempt, urgent_arrival):
    ex = P.ChannelSim(P.DeviceModel())
    sched = P.Scheduler(_engine(P, "contiguous_kv", ex), policy="slo_aware", max_concurrency=1,
                        preempt=preempt, swap_on_preempt=True, prefill_estimate=10.0)
    done = sched.run([P.Request(request_id=0, suffix=_suffix(0), arrival=0.0, decode_tokens=6),
                      P.Request(request_id=1, suffix=_suffix(1), arrival=urgent_arrival,
                                ttft_target=1e-3)])
    return run_digest(P, sched, ex, done)


def test_preempt_resume_round_trip_preserves_plan():
    """A preemption with swap out and back in the victim's decode: equal to
    the JAX run; the victim's selections and first token are the
    uninterrupted run's, it finishes later, the urgent request sooner."""
    ref = serial(PORT, "contiguous_kv", decode=6, n=1)[0]
    urgent = (ref["decode_times"][1] + ref["decode_times"][2]) / 2
    got = _preempt(PORT, True, urgent)
    assert_same(got, _preempt(JAX, True, urgent))
    base = _preempt(PORT, False, urgent)
    assert got["counters"][:2] == [1, 1] and base["counters"][:2] == [0, 0]
    v, vb = got["traces"][0], base["traces"][0]
    for k in ("ttft", "first_token_at", "selected_per_period", "decode_selected"):
        assert v[k] == vb[k], k
    assert got["done"][0][2] > base["done"][0][2] and got["done"][1][3] < base["done"][1][3]


# ----------------------------------------------------- topologies and fleets
def fleet_run(P, *, topo=None, replicas=None, hybrid="off", fleet=None, system="contiguous_kv",
              tenants=2, n=6, conc=4, decode=4, chunk=None, scale=1, **kw):
    """build_sim_fleet over one ChannelSim (the SSD derated ``scale`` times),
    ``n`` requests arriving every 2 ms, round-robin over the tenants."""
    model = P.DeviceModel(ssd_bandwidth=7.45e9 / scale, ssd_iops=600e3 / scale)
    t = P.DisaggTopology.parse(topo) if topo else None
    r = P.ReplicaSet.parse(replicas) if replicas else None
    f = P.build_sim_fleet(system, MODEL, n_tenants=tenants, prefix_len=1024, device_cap=64,
                          host_cap=256, device_model=model, prefill_chunk_tokens=chunk,
                          hybrid_reprefill=hybrid, topology=t, replicas=r, fleet=fleet, **kw)
    sched = P.Scheduler(f.engines, max_concurrency=conc, topology=t, replicas=r)
    k = len(f.engines)
    reqs = [P.Request(request_id=i, suffix=np.arange(64) % 100, arrival=0.002 * i,
                      tenant=1 + i % k, decode_tokens=decode) for i in range(n)]
    return run_digest(P, sched, f.executor, sched.run(reqs))


@pytest.mark.parametrize("topo,hybrid,scale", [("1:1", "off", 1), ("1:2", "off", 1),
                                               ("2:2", "off", 1), ("1:1", "auto", 64),
                                               ("2:1", "force-compute", 1)])
def test_disaggregated_sim_matches_jax(topo, hybrid, scale):
    """P prefill and D decode workers, each its own channel, the KV handoff
    on the interconnect or (the planner's price_handoff) recomputed on the
    decode worker."""
    kw = dict(topo=topo, hybrid=hybrid, scale=scale)
    got = fleet_run(PORT, **kw)
    assert_same(got, fleet_run(JAX, **kw))
    assert got["counters"][3] == 6  # one handoff a request
    if hybrid == "force-compute":  # every handoff recomputed on a decode worker
        assert got["counters"][4:7] == [0, 6, got["counters"][6]] and got["counters"][6] > 0
    else:  # every handoff pulled over the interconnect
        assert got["counters"][4] > 0 and got["counters"][5] == 0
    assert any(res.startswith("compute:d") for _, _, res, _ in got["events"])


@pytest.mark.parametrize("replicas,topo", [("2", None), ("3", None), ("2", "1:1")])
def test_replicas_sim_matches_jax(replicas, topo):
    """N replicas behind one Scheduler, each its own compute channel (or
    worker split): least-backlogged admission, batches within a replica."""
    got = fleet_run(PORT, replicas=replicas, topo=topo, n=8)
    assert_same(got, fleet_run(JAX, replicas=replicas, topo=topo, n=8))
    assert sum(got["counters"][7]) == 8 and min(got["counters"][7]) > 0


@pytest.mark.parametrize("kw", [
    dict(fleet="qwen2_5_7b:2,falcon_mamba_7b:1,hymba_1_5b:1"),
    dict(fleet="qwen2_5_7b:1,falcon_mamba_7b:1,hymba_1_5b:1", chunk=64, max_batch_tokens=None),
    dict(fleet="qwen2_5_7b:2,hymba_1_5b:1", replicas="2", topo="1:1", hybrid="auto"),
    dict(fleet="qwen2_5_14b:1,qwen2_5_7b:1", system="impress"),
], ids=["mixed", "mixed_chunked", "replicas_disagg_auto", "two_dense_impress"])
def test_fleet_sim_matches_jax(kw):
    """Heterogeneous fleets: the same timeline; every batch one model's
    weight stream (a state-space decode batches only with its own model)."""
    kw = {k: v for k, v in kw.items() if v is not None}
    got = fleet_run(PORT, n=8, **kw)
    assert_same(got, fleet_run(JAX, n=8, **kw))
    for batch in got["sim_batch_log"]:
        assert len({key.rpartition("@")[2] for _, _, key in batch}) == 1, batch


def test_tiered_shared_prompt_fleet_matches_jax():
    """Two tenants of one prompt over the three-tier store (plan mode) and a
    third of its own: dedup, SSD-tier hits and compaction as in JAX."""
    kw = dict(tenants=3, ssd_cap=512, segment_units=16, conc=3, n=9,
              prefix_digests={1: "shared", 2: "shared", 3: "own"})
    got = fleet_run(PORT, **kw)
    assert_same(got, fleet_run(JAX, **kw))
    assert sum(t["hits_ssd"] for t in got["traces"]) > 0


# ---------------------------------------------------------- serve --mode sim
@pytest.mark.parametrize("argv", [
    [],
    ["--disaggregate", "1:2", "--decode-tokens", "4"],
    ["--replicas", "2", "--decode-tokens", "3"],
    ["--fleet", "qwen2_5_7b:2,falcon_mamba_7b:1,hymba_1_5b:1", "--decode-tokens", "3"],
    ["--tenants", "3", "--policy", "cache_aware", "--arrival", "burst", "--cache-tiers",
     "64:128:512", "--shared-prefix", "2", "--hybrid-reprefill", "auto"],
    ["--system", "impress", "--requests", "4", "--decode-tokens", "2", "--preempt",
     "--swap-on-preempt", "--ttft-slo", "0.01", "--policy", "slo_aware",
     "--prefill-chunk-tokens", "16", "--max-batch-tokens", "64"],
], ids=["defaults", "disaggregate", "replicas", "fleet", "tiers_shared_auto", "impress_preempt"])
def test_serve_sim_cli_matches_jax(argv, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --mode sim`` prints what the JAX
    package's ``--mode sim`` prints for the same arguments."""
    args = ["--mode", "sim"] + argv
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jax_serve.main()
    want = capsys.readouterr().out
    done = serve.main(args)
    assert capsys.readouterr().out == want
    assert done and all(c.result is None and c.trace.ttft > 0 for c in done)
    assert "p50=" in want and "goodput=" in want


def test_sim_ignores_tp_decode(capsys):
    """--mode sim prints exactly what it prints without --tp-decode, as the
    JAX package's sim mode ignores the flag."""
    argv = ["--mode", "sim", "--requests", "4", "--decode-tokens", "2"]
    serve.main(argv)
    want = capsys.readouterr().out
    done = serve.main(argv + ["--tp-decode", "2"])
    assert capsys.readouterr().out == want
    assert len(done) == 4 and "p50=" in want
