"""The port's roofline analyzer (``launch/roofline.py``) against the JAX
package's (``src/repro/launch/roofline.py``), on the CPU.

The JAX tests parse compiled HLO; the port counts a step as it runs
(``StepAnalyzer``, a dispatch mode). Ported: the report's arithmetic on the
same metrics, a repeated loop counted as its repeats, the gather's
all-gather bytes, per-device FLOPs (the port's own split), and the pricing
of groups that leave a node. Added: the kernels' work against the bounds
``PERF.md`` records, and the wrappers' meta routes. Tolerances: exact for
counts of integers; the reports' float terms to 1e-12 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import build as B
from repro_torch.kernels import work as W
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.kernels.selective_scan import ops as ss
from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref, selective_scan_ref
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import (NamedSharding, P, block_index, param_shardings, shard,
                                         shard_tree)
from repro_torch.models import transformer as PT
from repro_torch.train.optimizer import adamw_init

META = torch.device("meta")
# the H100's special-function units as PERF.md prices them: 16 exponentials
# a clock an SM, 132 SMs, 1980 MHz
EXP_PER_S = 16 * 132 * 1980e6


def _bound_ms(work: W.KernelWork):
    terms = {"bytes": work.bytes / 3.35e12, "products": work.products / 989e12,
             "exponentials": work.exponentials / EXP_PER_S}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, term


def test_roofline_report_matches_jax():
    """The same metrics and hardware give JAX's report, field by field: the
    NVLink and cross-node rates stand where JAX's ICI and DCN rates stand."""
    from repro.launch import roofline as JR

    for groups in ({4: 3.0}, {2: 1.5, 8: 3.0}, {}):
        kw = dict(flops=500.0, hbm_bytes=40.0, hbm_bytes_min=20.0,
                  coll_bytes={"all-reduce": sum(groups.values())}, coll_by_group=groups)
        common = dict(arch="a", shape="s", mesh="multi", model_flops_per_device=400.0,
                      bytes_per_device=7.0, cross_pod_groups=(2,), note="n")
        got = RL.roofline(RL.Metrics(**kw), hw=RL.Hardware(peak_flops=100.0, hbm_bw=10.0,
                                                            nvlink_bw=1.0, ib_bw=0.5),
                          **common).to_dict()
        want = JR.roofline(JR.Metrics(**kw), hw=JR.Hardware(peak_flops=100.0, hbm_bw=10.0,
                                                             ici_bw=1.0, dcn_bw=0.5),
                           **common).to_dict()
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], float):
                assert got[k] == pytest.approx(want[k], rel=1e-12), k
            else:
                assert got[k] == want[k], k
    rep = RL.roofline(RL.Metrics(flops=500.0, hbm_bytes=40.0, hbm_bytes_min=20.0,
                                 coll_bytes={"all-reduce": 3.0}, coll_by_group={8: 3.0}),
                      arch="a", shape="s", mesh="single", model_flops_per_device=400.0,
                      hw=RL.Hardware(peak_flops=100.0, hbm_bw=10.0, nvlink_bw=1.0))
    assert (rep.t_compute, rep.t_memory, rep.t_memory_upper, rep.t_collective) == (
        pytest.approx(5.0), pytest.approx(2.0), pytest.approx(4.0), pytest.approx(3.0))
    assert rep.dominant == "compute" and rep.useful_ratio == pytest.approx(0.8)


def test_cross_pod_and_cross_node_groups_use_ib_bandwidth():
    """A group in cross_pod_groups, or larger than one 8-GPU NVLink domain,
    is priced at ib_bw; a group within a node at nvlink_bw."""
    hw = RL.Hardware(nvlink_bw=100.0, ib_bw=10.0)
    m = RL.Metrics(coll_by_group={2: 10.0, 8: 10.0, 16: 10.0},
                   coll_bytes={"all-reduce": 30.0})
    rep = RL.roofline(m, arch="a", shape="s", mesh="multi", model_flops_per_device=1.0,
                      hw=hw, cross_pod_groups=(2,))
    assert rep.t_collective == pytest.approx(10.0 / 10.0 + 10.0 / 100.0 + 10.0 / 10.0)
    rep = RL.roofline(m, arch="a", shape="s", mesh="single", model_flops_per_device=1.0,
                      hw=hw, cross_pod_groups=())
    assert rep.t_collective == pytest.approx(10.0 / 100.0 + 10.0 / 100.0 + 10.0 / 10.0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_loop_of_products_counts_each(device):
    """Ten products in an eager loop count ten times one, and a
    ``roofline.loop`` of ten counts the same whether it samples (one item
    run, counted ten times) or runs every item."""
    x = torch.ones(64, 128, device=device)
    w = torch.ones(128, 128, device=device)
    one = 2 * 64 * 128 * 128
    with RL.StepAnalyzer() as eager:
        for _ in range(10):
            torch.tanh(x @ w)
    runs = {}
    for sample in (True, False):
        with RL.StepAnalyzer(sample_loops=sample) as a:
            for _ in RL.loop(range(10)):
                runs[sample] = runs.get(sample, 0) + 1
                torch.tanh(x @ w)
        assert a.metrics.flops == eager.metrics.flops == 10 * one
        assert a.metrics.hbm_bytes == eager.metrics.hbm_bytes
        assert a.metrics.hbm_bytes_min == eager.metrics.hbm_bytes_min
    assert runs == {True: 1, False: 10}
    # per_device: a loop spread on 5 devices is 2 items' work a device
    with RL.StepAnalyzer() as a:
        for _ in RL.loop(range(10), per_device=1 / 5):
            x @ w
    assert a.metrics.flops == 2 * one and a.whole.flops == 10 * one


def _mesh_step_inputs(cfg, mesh, b=4, s=32, seed=0):
    params = PT.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    sh = param_shardings(cfg, mesh)
    opt = adamw_init(params)
    rep = NamedSharding(mesh, P())
    opt_sh = {"m": sh, "v": sh, "step": rep}
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": torch.as_tensor(seq[:, :-1]), "labels": torch.as_tensor(seq[:, 1:])}
    return shard_tree(params, sh), shard_tree(opt, opt_sh), batch


def _count(step, *args, sample=True):
    with RL.StepAnalyzer(sample_loops=sample) as a:
        step(*args)
    return a


def test_sampled_loops_equal_a_full_count():
    """The mesh train step's parts and AdamW's positions counted by sampling
    (one item run for all) equal the count that runs every item, at a small
    size: FLOPs, bytes and collective bytes, per device and whole."""
    cfg = dataclasses.replace(reduced_config("qwen3-1.7b"), n_layers=2)
    mesh = make_host_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    step = PS.make_train_step(cfg, grad_accum=2, remat=True, mesh=mesh)
    args = _mesh_step_inputs(cfg, mesh, b=8)
    sampled, full = _count(step, *args), _count(step, *args, sample=False)
    for m_s, m_f in ((sampled.metrics, full.metrics), (sampled.whole, full.whole)):
        assert m_s.flops == m_f.flops > 0
        assert m_s.hbm_bytes == pytest.approx(m_f.hbm_bytes, rel=1e-12)
        assert m_s.hbm_bytes_min == pytest.approx(m_f.hbm_bytes_min, rel=1e-12)
        assert m_s.coll_bytes == pytest.approx(m_f.coll_bytes, rel=1e-12)
        assert m_s.coll_by_group == pytest.approx(m_f.coll_by_group, rel=1e-12)
    assert sampled.aten_flops == full.aten_flops


def test_mesh_gather_reports_all_gather_bytes():
    """The train step's weight gather (``tp_compute._WeightGather``) on a 2 x
    2 CPU mesh, a whole leaf gathered for position (0, 0): forward an
    all-gather over the leaf's g distinct blocks at the ring factor (g - 1)
    / g of the gathered leaf, backward a reduce-scatter of its gradient
    (each block's share, g - 1 times on the wire); a replicated leaf, read
    where it lies, moves nothing. The gathered leaf is the leaf, and its
    gradient lands block by block in the sink's float32 accumulators."""
    from repro_torch.launch import tp_compute as TPC

    cpu = torch.device("cpu")
    mesh = make_host_mesh(2, 2, devices=[cpu] * 4)
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    tree = {"model": shard(x, NamedSharding(mesh, P(None, "model"))),
            "both": shard(x, NamedSharding(mesh, P("data", "model"))),
            "replicated": shard(x, NamedSharding(mesh, P()))}
    sink = TPC.GradSink(tree)
    train = TPC._Train(sink, 1.0)
    train.open_scope()
    coef = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    with RL.StepAnalyzer() as a, torch.enable_grad():
        got = {k: TPC._WeightGather.apply(train.anchor, st, (slice(None),), cpu, (0, 0),
                                          train.scope) for k, st in tree.items()}
        fwd = dict(a.metrics.coll_bytes)
        torch.autograd.backward(sum((g * coef).sum() for g in got.values()))
    size = x.numel() * 4
    assert fwd == {"all-gather": pytest.approx(size / 2 + size * 3 / 4)}
    assert a.metrics.coll_bytes == {"all-gather": pytest.approx(size / 2 + size * 3 / 4),
                                    "reduce-scatter": pytest.approx(size / 2 + size * 3 / 4)}
    assert a.metrics.coll_by_group == {2: pytest.approx(size), 4: pytest.approx(size * 3 / 2)}
    assert a.whole.coll_bytes == a.metrics.coll_bytes
    for k, st in tree.items():
        assert torch.equal(got[k].detach(), x)
        for pos in st.positions():
            sl = block_index(st.shape, st.sharding, pos)
            assert torch.equal(sink.acc[st][TPC.GradSink.key(st, pos)], coef[sl])


def test_dot_flops_per_device_are_split_over_dp_not_model():
    """Per-device FLOPs of the mesh train step are its whole step's over
    every shard, data-parallel and tensor: 2 x 2 gives a quarter of the
    step without a mesh on the same rows, 2 x 1 half, 1 x 1 all of it, and
    the whole 2 x 2, 2 x 1 and 1 x 1 steps equal the step without a mesh.
    On 1 x 4 the reduced qwen3's 2 kv heads are each computed by the two
    shards that read them (its 4 q heads one a shard), so its whole step
    adds those projections, forward and backward, and a device's share is
    a quarter of that.

    JAX's ``test_dot_flops_per_device_are_sharded`` finds a product sharded
    over both axes (GSPMD splits each product over ``model`` too); the
    port's step splits heads, d_ff columns and the vocabulary over the
    tensor shards (``launch/tp_compute.py``), and the rows over dp."""
    cfg = dataclasses.replace(reduced_config("qwen3-1.7b"), n_layers=2)
    cpu = torch.device("cpu")
    flops = {}
    for shape in ((2, 2), (2, 1), (1, 4), (1, 1)):
        mesh = make_host_mesh(*shape, devices=[cpu] * (shape[0] * shape[1]))
        step = PS.make_train_step(cfg, grad_accum=1, remat=False, mesh=mesh)
        a = _count(step, *_mesh_step_inputs(cfg, mesh))
        flops[shape] = (a.metrics.flops, a.whole.flops)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab_size, (4, 33))
    batch = {"tokens": torch.as_tensor(seq[:, :-1]), "labels": torch.as_tensor(seq[:, 1:])}
    plain = _count(PS.make_train_step(cfg, grad_accum=1, remat=False), params,
                   adamw_init(params), batch).metrics.flops
    assert flops[2, 2][1] == flops[2, 1][1] == flops[1, 1][1] == flops[1, 1][0] == plain > 0
    assert flops[2, 2][0] == plain / 4 and flops[2, 1][0] == plain / 2
    # the kv projections, a layer: 2 (wk, wv) x 3 (forward, two backward) x
    # 2 b s d (n_kv d_head) flops, done once more by the second shard of
    # each kv head
    kv = cfg.n_layers * 2 * 3 * 2 * (4 * 32) * cfg.d_model * (cfg.n_kv_heads * cfg.d_head)
    assert flops[1, 4][1] == plain + kv and flops[1, 4][0] == (plain + kv) / 4


def test_kernel_work_reproduces_recorded_bounds():
    """``kernel_work`` gives the bounds PERF.md §6 records from the chip
    runs: flash at qwen2.5-7b's 28 / 4 heads, s 4096, d 128 (0.1216 ms, by
    products), its backward at qwen3-1.7b's 16 / 8 heads (0.17375 ms, five
    products a pair), windowed 1024 (0.0760), and hymba's chunked scan
    prefill, s 4160, d_inner 3200, n 16 (0.0509 ms by exponentials, bytes
    0.0240); the pair counts are the causal half."""
    shapes = dict(b=1, s_q=4096, s_k=4096, d=128, itemsize=2, causal=True, window=0)
    cases = [
        (W.kernel_work("flash_attention", n_q=28, n_kv=4, **shapes), 4, 0.1216, "products"),
        (W.kernel_work("flash_attention_bwd", n_q=16, n_kv=8, **shapes), 5, 0.17375,
         "products"),
        (W.kernel_work("flash_attention_bwd", n_q=16, n_kv=8, **dict(shapes, window=1024)), 4,
         0.0760, "products"),
        (W.kernel_work("selective_scan", b=1, s=4160, d_in=3200, n=16, itemsize=2,
                        dt_itemsize=2), 4, 0.0509, "exponentials"),
    ]
    for work, digits, want, term in cases:
        ms, got_term = _bound_ms(work)
        assert (round(ms, digits), got_term) == (want, term)
    scan = cases[3][0]
    assert round(scan.bytes / 3.35e12 * 1e3, 4) == 0.0240
    assert W.visible_pairs(4096, 4096) == 4096 * 4097 // 2
    assert W.visible_pairs(4096, 4096, window=1024) == 1024 * 1025 // 2 + 3072 * 1024
    assert W.visible_pairs(8, 16, q_offset=8) == sum(range(9, 17))
    assert W.visible_pairs(4, 6, causal=False) == 24


def _meta(*tensors):
    return [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=META)
            for t in tensors]


def _same_layout(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)


@pytest.fixture
def no_library(monkeypatch):
    """The kernels' library may not be built or loaded: a meta call that
    reached it would raise here."""
    def refuse():
        raise AssertionError("a meta call reached the CUDA library")

    monkeypatch.setattr(B, "library", refuse)


def test_meta_calls_launch_nothing_and_match_plain_shapes(no_library):
    """Each wrapper on the dry run's path, called on meta tensors, returns
    the shapes and dtypes of its plain version's outputs on the same shapes,
    reports one launch of the variant the card would run and its kernel's
    work to the analyzer, and launches nothing: the library is never
    reached and the wrappers' own launch counters do not move. A wrapper
    without a meta route refuses meta tensors."""
    rng = np.random.default_rng(3)

    def rn(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    bf = torch.bfloat16
    # flash forward and backward, bfloat16 d 64 (wgmma), (b, s, n, d) views
    q, k, v = (rn(1, 48, n, 64, dtype=bf).transpose(1, 2) for n in (4, 2, 2))
    out_ref = flash_attention_ref(q, k, v, window=16)
    do = rn(*q.shape, dtype=bf)
    before = (fa.launches, fa.bwd_launches, dict(fa.launches_by_variant),
              dict(fa.bwd_launches_by_variant), fa.dout_copies)
    with RL.StepAnalyzer() as a:
        qm, km, vm, om, dm = _meta(q, k, v, out_ref, do)
        lse = fa.lse_buffer(qm)
        got = fa.flash_attention(qm, km, vm, window=16, lse=lse)
        assert got.stride() == qm.stride()
        _same_layout([got], [out_ref])
        _same_layout(fa.flash_attention_bwd(qm, km, vm, om, dm, window=16, lse=lse),
                     flash_attention_bwd_ref(q, k, v, out_ref, do, window=16))
        leaves = [t.requires_grad_() for t in _meta(q, k, v)]
        y = fa.FlashAttentionFn.apply(*leaves, True, 16, 0)
        _same_layout(torch.autograd.grad(y, leaves, torch.empty_like(y)), leaves)
    assert before == (fa.launches, fa.bwd_launches, fa.launches_by_variant,
                      fa.bwd_launches_by_variant, fa.dout_copies)
    assert a.launches == {("flash_attention", "wgmma"): 2, ("flash_attention_bwd", "wgmma"): 2}
    shapes = dict(b=1, n_q=4, n_kv=2, s_q=48, s_k=48, d=64, itemsize=2, causal=True, window=16)
    w_f = W.kernel_work("flash_attention", **shapes, lse_rows=fa.LSE_ROW_ALIGN)
    w_b = W.kernel_work("flash_attention_bwd", **shapes)
    assert a.kernels["flash_attention"]["products"] == 2 * w_f.products
    assert a.kernels["flash_attention_bwd"]["bytes"] == 2 * w_b.bytes

    # the scan: chunked prefill with carries, the decode step, the backward
    x, A, proj, dy = rn(2, 40, 32), -torch.exp(rn(32, 8)), rn(2, 40, 17), rn(2, 40, 32)
    dt = torch.nn.functional.softplus(rn(2, 40))
    args = (x, dt, A, proj[..., :8], proj[..., 8:16])
    h0 = rn(2, 32, 8)
    before = (ss.launches, ss.bwd_launches, dict(ss.launches_by_variant))
    with RL.StepAnalyzer() as a:
        m_args = _meta(*args)
        carries = ss.carries_buffer(m_args[0], 8)
        _same_layout(ss.selective_scan(*m_args, carries=carries), selective_scan_ref(*args))
        step = [m_args[0][:, :1].contiguous(), m_args[1][:, :1], m_args[2],
                m_args[3][:, :1], m_args[4][:, :1]]
        _same_layout(ss.selective_scan(*step, *_meta(h0)),
                     selective_scan_ref(x[:, :1], dt[:, :1], A, *[t[:, :1] for t in args[3:]],
                                        h0))
        _same_layout(ss.selective_scan_bwd(*m_args, None, *_meta(dy), carries=carries),
                     selective_scan_bwd_ref(*args, None, dy))
        leaves = [t.requires_grad_() for t in _meta(x)]
        y, _ = ss.SelectiveScanFn.apply(leaves[0], *m_args[1:])
        _same_layout(torch.autograd.grad(y, leaves, torch.empty_like(y)), leaves)
    assert before == (ss.launches, ss.bwd_launches, ss.launches_by_variant)
    assert a.launches == {("selective_scan", "chunked"): 2, ("selective_scan", "sequential"): 1,
                          ("selective_scan_bwd", "chunked"): 2}

    # decode_attention has no meta route (the dry run's sparse decode is
    # plain torch): both its forms refuse meta tensors
    qd, kp, vp = rn(2, 4, 16), rn(2, 5, 16, 2, 16), rn(2, 5, 16, 2, 16)
    table = torch.tensor([[0, 1, 2], [3, -1, 4]], dtype=torch.int32)
    lens = torch.tensor([40, 20], dtype=torch.int32)
    with pytest.raises(ValueError, match="no meta route"):
        da.decode_attention(*_meta(qd, kp, vp, table, lens), return_lse=True)
    with pytest.raises(ValueError, match="no meta route"):
        da.decode_attention_pools(*_meta(qd), list(_meta(kp[0], kp[1])),
                                  list(_meta(vp[0], vp[1])), *_meta(table, lens))


def test_active_finds_the_innermost_recorder_and_costs_nothing_outside_one():
    """``work.active()`` is None outside any analyzer (its fast path: no
    recorder entered), the innermost analyzer inside nested ones, and None
    again once they are left, an exception included."""
    assert W._entered == 0 and W.active() is None
    with RL.StepAnalyzer() as outer:
        assert W.active() is outer
        with RL.StepAnalyzer() as inner:
            assert W.active() is inner and W._entered == 2
        assert W.active() is outer
    with pytest.raises(RuntimeError, match="left"):
        with RL.StepAnalyzer():
            raise RuntimeError("left")
    assert W._entered == 0 and W.active() is None


def test_peak_bytes_follow_storage_lifetimes():
    """The analyzer's live bytes rise with each new storage and fall when it
    is freed, views and in-place ops allocating nothing; the peak is the
    most held at once."""
    with RL.StepAnalyzer() as a:
        x = torch.empty(1000, device=META)  # 4000 bytes
        y = x * 2  # 4000 more
        y.add_(1.0)  # in place: nothing new
        z = y.view(10, 100)  # a view: nothing new
        del x
        w = torch.empty(500, device=META)  # 2000: 6000 live, peak 8000
    assert (a.peak_bytes, a.live_bytes) == (8000, 6000)
    del y, z, w
    assert a.live_bytes == 0
