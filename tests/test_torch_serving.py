"""The port's real-mode serving stack on the CPU, against its own serial
driver and against the JAX package's scheduler.

Reduced float32 Qwen2.5-7B (2 layers), the real parts of the JAX package's
tests/test_serving_parity.py, tests/test_disagg.py and tests/test_replicas.py:

- ``Scheduler(max_concurrency=1)`` equals ``drive_serial`` bit for bit for
  all four engines (logits, greedy tokens, selections, decode selections);
  against the JAX package's ``Scheduler(max_concurrency=1)``: the same
  selections and greedy tokens, logits within 1e-3 of their scale (float32
  in both, summed in other orders, plus the rare float16 store value one
  ulp apart: tests/test_torch_baselines.py's bound);
- batched decode at c = 4 against unbatched: the same greedy tokens, logits
  within 1e-5 (a batched product of b rows sums as one row's does, bar the
  order of a few float32 sums), every batch of at least two members;
- preempt -> swap -> resume equals the uninterrupted run bit for bit, with
  the swap bytes counted on both legs;
- a disaggregated 1:2 topology and two replicas at c = 1 equal the
  colocated run bit for bit;
- ``summarize`` and the arrival processes equal the JAX package's on the
  same inputs; ``launch.serve`` runs in-process on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core import build_real_session as jax_build_session
from repro.core.backends import RealCompute as JaxCompute
from repro.core.engine import ReprefillTrace as JaxTrace
from repro.data.synthetic import make_task as jax_make_task
from repro.models import transformer as JT
from repro.serving import CompletedRequest as JaxCompleted
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro.serving import arrivals as jax_arrivals
from repro.serving import summarize as jax_summarize
from repro.serving.tenancy import ENGINE_CLASSES as JAX_ENGINES
from repro.storage.timing import RealExecutor as JaxExecutor
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.backends import DeviceTailPool, RealCompute
from repro_torch.core.engine import ReprefillTrace
from repro_torch.core.session import build_real_session
from repro_torch.data.synthetic import make_task
from repro_torch.launch import serve
from repro_torch.serving import (ENGINE_CLASSES, CompletedRequest, DisaggTopology, ReplicaSet,
                                 Request, Scheduler, arrivals, summarize)
from repro_torch.storage.timing import ChannelSim, DeviceModel, RealExecutor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SYSTEMS = list(ENGINE_CLASSES)
PREFIX, SUFFIX, DECODE = 128, 24, 3


@pytest.fixture(scope="module")
def stack():
    """Shared float32 weights (JAX's, bridged) and both packages' sessions."""
    cfg = dataclasses.replace(jax_reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    pcfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    prefix = (np.arange(PREFIX) % cfg.vocab_size).astype(np.int64)
    psess = {coarse: build_real_session(pcfg, tparams, prefix, coarse_blocks=coarse,
                                        in_memory=True, device="cpu")
             for coarse in (False, True)}
    jsess = {coarse: jax_build_session(cfg, params, prefix, coarse_blocks=coarse,
                                       in_memory=True)
             for coarse in (False, True)}
    return cfg, pcfg, params, tparams, psess, jsess


def _kw(system):
    kw = dict(device_cap=64, host_cap=128)
    if system == "contiguous_kv":
        kw.update(budget=0.5, period=2, subperiod=1)
    elif system != "as_lru":
        kw.update(budget=0.5)
    return kw


def _engine(system, stack, backend=None):
    _, pcfg, _, tparams, psess, _ = stack
    be = backend or RealCompute(pcfg, tparams, device="cpu")
    return ENGINE_CLASSES[system](psess[system != "contiguous_kv"], be, RealExecutor(),
                                  **_kw(system))


def _suffix(rid, vocab):
    return (np.arange(SUFFIX) + 3 * rid) % vocab


def _requests(cfg, n, cls=Request, **kw):
    return [cls(request_id=r, suffix=_suffix(r, cfg.vocab_size), decode_tokens=DECODE, **kw)
            for r in range(n)]


@pytest.fixture(scope="module")
def serial(stack):
    """system -> [(logits, trace)] of drive_serial on a fresh engine."""
    cfg = stack[0]
    out = {}
    for system in SYSTEMS:
        eng = _engine(system, stack)
        out[system] = [eng.reprefill(_suffix(r, cfg.vocab_size), request_id=r,
                                     decode_tokens=DECODE) for r in range(2)]
    return out


def _same_run(c, logits, trace):
    np.testing.assert_array_equal(c.result, logits)
    assert c.trace.decode_tokens_out == trace.decode_tokens_out
    assert set(c.trace.selected_per_layer) == set(trace.selected_per_layer)
    for l, sel in trace.selected_per_layer.items():
        np.testing.assert_array_equal(c.trace.selected_per_layer[l], sel)
    assert len(c.trace.decode_selected) == len(trace.decode_selected) == DECODE
    for got, ref in zip(c.trace.decode_selected, trace.decode_selected):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("system", SYSTEMS)
def test_concurrency_one_bit_identical_to_serial(system, stack, serial):
    sched = Scheduler(_engine(system, stack), max_concurrency=1)
    done = sched.run(_requests(stack[0], 2))
    assert sched.real_batch_log == []  # a lone plan never enters the batcher
    assert [c.request.request_id for c in done] == [0, 1]
    for c, (logits, trace) in zip(done, serial[system]):
        _same_run(c, logits, trace)


@pytest.mark.parametrize("system", SYSTEMS)
def test_concurrency_one_matches_jax(system, stack):
    cfg, _, params, _, _, jsess = stack
    jeng = JAX_ENGINES[system](jsess[system != "contiguous_kv"], JaxCompute(cfg, params),
                               JaxExecutor(), **_kw(system))
    jdone = JaxScheduler(jeng, max_concurrency=1).run(_requests(cfg, 2, JaxRequest))
    done = Scheduler(_engine(system, stack), max_concurrency=1).run(_requests(cfg, 2))
    for c, jc in zip(done, jdone):
        assert c.trace.decode_tokens_out == jc.trace.decode_tokens_out
        for l, sel in jc.trace.selected_per_layer.items():
            np.testing.assert_array_equal(c.trace.selected_per_layer[l], sel)
        for got, ref in zip(c.trace.decode_selected, jc.trace.decode_selected):
            np.testing.assert_array_equal(got, ref)
        ref = np.asarray(jc.result)
        np.testing.assert_allclose(c.result, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("system", ["contiguous_kv", "as_lru"])
def test_batched_decode_matches_unbatched(system, stack):
    runs = {}
    for batched in (True, False):
        sched = Scheduler(_engine(system, stack), max_concurrency=4, batch_decode=batched)
        runs[batched] = (sched.run(_requests(stack[0], 4)), sched)
    (done_b, sched_b), (done_u, sched_u) = runs[True], runs[False]
    assert sched_b.real_batch_log, "no batched decode iteration formed"
    assert all(len(m) >= 2 for m in sched_b.real_batch_log)
    assert all(phase == "decode" and key == f"model@{stack[1].name}"
               for m in sched_b.real_batch_log for _, phase, key in m)
    assert sched_u.real_batch_log == []
    for cb, cu in zip(done_b, done_u):
        assert cb.trace.decode_tokens_out == cu.trace.decode_tokens_out
        np.testing.assert_allclose(cb.result, cu.result, rtol=0, atol=1e-5)


def _preempt_run(stack, preempt, monkeypatch=None):
    cfg = stack[0]
    sched = Scheduler(_engine("contiguous_kv", stack), policy="fcfs", max_concurrency=1,
                      preempt=preempt, swap_on_preempt=True, prefill_estimate=10.0)
    reqs = [Request(request_id=0, suffix=_suffix(0, cfg.vocab_size), decode_tokens=DECODE),
            Request(request_id=1, suffix=_suffix(1, cfg.vocab_size), ttft_target=1e-6)]
    return sched, {c.request.request_id: c for c in sched.run(reqs)}


def test_preempt_swap_resume_bit_identical(stack, serial, monkeypatch):
    """FCFS puts the decode-bearing request in the one slot; the urgent one
    projects a TTFT miss, preempts it at a decode step, its pools go to host
    memory and come back when the slot frees."""
    legs = {"out": 0, "in": 0}
    real = {"out": DeviceTailPool.swap_out, "in": DeviceTailPool.swap_in}

    def metered(leg):
        def wrapped(self):
            n = real[leg](self)
            legs[leg] += n
            return n
        return wrapped

    monkeypatch.setattr(DeviceTailPool, "swap_out", metered("out"))
    monkeypatch.setattr(DeviceTailPool, "swap_in", metered("in"))
    sched, done = _preempt_run(stack, preempt=True)
    assert sched.preemptions == 1 and sched.swaps == 1
    assert legs["out"] == legs["in"] > 0
    assert sched.swap_bytes == legs["out"] + legs["in"]
    victim = done[0]
    assert (victim.preemptions, victim.swaps, done[1].preemptions) == (1, 1, 0)
    logits, trace = serial["contiguous_kv"][0]
    _same_run(victim, logits, trace)
    assert len(victim.trace.decode_times) == DECODE


def test_preempt_disabled_never_preempts(stack):
    sched, done = _preempt_run(stack, preempt=False)
    assert sched.preemptions == 0 and sched.swaps == 0
    assert all(c.preemptions == 0 for c in done.values())


class _Counting(RealCompute):
    """A backend that counts the decode positions it ran."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.decode_steps = 0

    def decode_attend(self, layer, h, q, tail):
        if layer == 0:
            self.decode_steps += 1
        return super().decode_attend(layer, h, q, tail)


def _same_as_colocated(ref, got):
    for ca, cb in zip(ref, got):
        np.testing.assert_array_equal(cb.result, ca.result)
        assert cb.trace.decode_tokens_out == ca.trace.decode_tokens_out
        for l, sel in ca.trace.selected_per_layer.items():
            np.testing.assert_array_equal(cb.trace.selected_per_layer[l], sel)
        for ga, gb in zip(ca.trace.decode_selected, cb.trace.decode_selected):
            np.testing.assert_array_equal(ga, gb)


def test_disaggregated_bit_identical_and_round_robin(stack):
    cfg, pcfg, _, tparams, _, _ = stack
    ref = Scheduler(_engine("contiguous_kv", stack), max_concurrency=1).run(_requests(cfg, 4))
    prefill_be = _Counting(pcfg, tparams, device="cpu")
    workers = [_Counting(pcfg, tparams, device="cpu") for _ in range(2)]
    sched = Scheduler(_engine("contiguous_kv", stack, prefill_be), max_concurrency=1,
                      topology=DisaggTopology(n_prefill=1, decode_backends=workers))
    got = sched.run(_requests(cfg, 4))
    _same_as_colocated(ref, got)
    assert sched.handoffs == 4 and sched.handoff_bytes > 0
    assert sched.handoff_bytes % 4 == 0  # the same payload per request
    # requests 0, 2 decode on worker 0, requests 1, 3 on worker 1
    assert [w.decode_steps for w in workers] == [2 * DECODE, 2 * DECODE]
    assert prefill_be.decode_steps == 0


def test_replicas_bit_identical(stack):
    cfg, pcfg, _, tparams, _, _ = stack
    ref = Scheduler(_engine("contiguous_kv", stack), max_concurrency=1).run(_requests(cfg, 3))
    reps = ReplicaSet(backends=[[RealCompute(pcfg, tparams, device="cpu")],
                                [RealCompute(pcfg, tparams, device="cpu")]])
    sched = Scheduler(_engine("contiguous_kv", stack), max_concurrency=1, replicas=reps)
    got = sched.run(_requests(cfg, 3))
    _same_as_colocated(ref, got)
    assert sched.handoffs == 3 and sched.handoff_bytes > 0
    assert sum(sched.replica_admits) == 3


def test_missing_backends_and_sim_raise(stack):
    cfg = stack[0]
    with pytest.raises(ValueError, match="decode_backends"):
        Scheduler(_engine("contiguous_kv", stack), max_concurrency=1,
                  topology=DisaggTopology.parse("1:1")).run(_requests(cfg, 1))
    with pytest.raises(ValueError, match="ReplicaSet.backends"):
        Scheduler(_engine("contiguous_kv", stack), max_concurrency=1,
                  replicas=ReplicaSet(n_replicas=2)).run(_requests(cfg, 1))
    eng = _engine("contiguous_kv", stack)
    eng.ex = ChannelSim(DeviceModel())
    with pytest.raises(NotImplementedError, match="sim slice"):
        Scheduler(eng).run(_requests(cfg, 1))
    with pytest.raises(ValueError):
        DisaggTopology.parse("2")


def test_summarize_matches_jax():
    rng = np.random.default_rng(3)
    port, jax_done = [], []
    for rid in range(5):
        arrival, admitted = rng.uniform(0, 1), rng.uniform(1, 2)
        first = rng.uniform(2, 3)
        times = list(first + np.cumsum(rng.uniform(0.01, 0.1, 4)))
        target = None if rid % 2 else rng.uniform(0.5, 3)
        for trace_cls, req_cls, done_cls, out in (
                (ReprefillTrace, Request, CompletedRequest, port),
                (JaxTrace, JaxRequest, JaxCompleted, jax_done)):
            tr = trace_cls(ttft=first - admitted, first_token_at=first,
                           decode_times=list(times))
            req = req_cls(request_id=rid, suffix=np.zeros(3), arrival=arrival,
                          ttft_target=target)
            out.append(done_cls(req, tr, None, admitted, times[-1], preemptions=rid % 3,
                                swaps=rid % 2))
    assert summarize(port) == jax_summarize(jax_done)
    assert summarize([]) == jax_summarize([]) == {"n": 0}


def test_arrivals_and_tasks_match_jax():
    for kind in ("poisson", "burst", "uniform"):
        np.testing.assert_array_equal(arrivals.make_arrivals(kind, 5.0, 12, seed=4),
                                      jax_arrivals.make_arrivals(kind, 5.0, 12, seed=4))
    np.testing.assert_array_equal(arrivals.burst_arrivals(9, jitter=0.1, seed=2),
                                  jax_arrivals.burst_arrivals(9, jitter=0.1, seed=2))
    np.testing.assert_array_equal(arrivals.poisson_arrivals(0.0, 3),
                                  jax_arrivals.poisson_arrivals(0.0, 3))
    with pytest.raises(ValueError):
        arrivals.make_arrivals("bursty", 1.0, 2)
    for name in ("rte", "trec"):
        t, jt = make_task(name, 256, n_queries=3), jax_make_task(name, 256, n_queries=3)
        np.testing.assert_array_equal(t.prefix, jt.prefix)
        for (s, c), (js, jc) in zip(t.queries, jt.queries):
            np.testing.assert_array_equal(s, js)
            assert c == jc


def test_serve_cli_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--arch", "qwen2.5-7b", "--n-layers", "2",
                       "--requests", "3", "--concurrency", "3", "--decode-tokens", "2",
                       "--period", "2", "--subperiod", "1"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(len(c.trace.decode_tokens_out) == 2 for c in done)
    assert "ingesting shared prefix" in out and "concurrency=3 policy=fcfs p50=" in out
    assert "decode: mean TPOT=" in out


@pytest.mark.parametrize("flags,slice_name", [
    (["--mode", "sim"], "sim slice"),
    (["--hybrid-reprefill", "force-compute"], "compute-or-load slice"),
    (["--hybrid-reprefill", "auto"], "compute-or-load slice"),
    (["--cache-tiers", "4:8:16"], "tier store"),
    (["--tp-decode", "0"], "multi-device slice"),
    (["--hybrid-reprefill", "force-load"], "compute-or-load slice"),
])
def test_serve_cli_refuses_deferred_flags(flags, slice_name):
    with pytest.raises(SystemExit, match=slice_name):
        serve.main(["--device", "cpu"] + flags)
