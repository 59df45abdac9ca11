"""The tensor-parallel train step's parts (``launch/tp_compute.py``) on the
CPU: the vocabulary-parallel cross entropy against ``cross_entropy``, which
``loss_fn`` calls, the three joins' backward against plain autograd on the
unsharded tensors, and the dry run's count of a train cell against the
count of a step whose dp shards compute with whole gathered params.

Limits: the loss and its gradient in float64 within 1e-12 relative of the
largest element (float64 sums in other orders); the joins bit for bit in
float64 where their sums keep autograd's order and within 1e-12 where they
reorder it; the dry-run ratios as the docstring of the last test says.
Also: a gradient scope that never drains fails ``GradSink.finish``, and the
clip's norm over a tree's blocks is its norm over whole leaves, bit for
bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch import tp_compute as TPC
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.sharding import NamedSharding, P, block_index, shard
from repro_torch.launch.specs import SHAPES, input_specs
from repro_torch.models import transformer as PT
from repro_torch.train.optimizer import global_norm, global_norm_blocks
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
F64 = torch.float64


def _close(got, want, rel=1e-12):
    assert got.shape == want.shape
    scale = max(float(want.abs().max()), 1e-300)
    assert float((got - want).abs().max()) <= rel * scale, (got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("vocab,n", [(12, 1), (12, 3), (9, 4)])
def test_vocab_parallel_cross_entropy_matches_loss_fn(vocab, n, masked):
    """The loss of logits split over n vocabulary shards ceil-wise (9 over
    4: 3, 3, 3 and a shard with none), and its gradient, against
    ``cross_entropy`` (``loss_fn``'s) on the whole float64 logits, with and
    without a ``loss_mask`` (one row masked out entirely)."""
    rng = np.random.default_rng(vocab * 10 + n)
    logits = torch.tensor(rng.normal(size=(3, 5, vocab)) * 3.0, dtype=F64)
    labels = torch.tensor(rng.integers(0, vocab, (3, 5)))
    mask = None
    if masked:
        mask = torch.tensor((rng.random((3, 5)) < 0.6), dtype=F64)
        mask[1] = 0.0
    whole = logits.clone().requires_grad_()
    want = PT.cross_entropy(whole, labels, mask)
    want.backward()
    leaf = logits.clone().requires_grad_()
    zs = {}
    for t in range(n):
        v0, v1 = TPC.split(vocab, n, t)
        if v1 > v0:
            zs[t] = (leaf[..., v0:v1], v0)
    assert len(zs) == (3 if (vocab, n) == (9, 4) else n)
    got = TPC.vocab_cross_entropy(zs, labels, mask, CPU, n)
    got.backward()
    _close(got.detach(), want.detach())
    _close(leaf.grad, whole.grad)


def _sharded(x, spec, grid=(2, 2)):
    mesh = make_host_mesh(*grid, devices=[CPU] * (grid[0] * grid[1]))
    return shard(x, NamedSharding(mesh, P(*spec)))


@pytest.mark.parametrize("spec", [(None, "model"), ("data", "model"), ()])
def test_weight_gather_backward_is_autograds(spec):
    """Two tensor shards' gathers of overlapping column slices of one leaf
    (a kv head both read), and a third of every column, each through
    ``_WeightGather`` for its position: the float32 accumulators hold, block
    by block, what autograd gives the unsharded leaf (the slices' gradients
    summed over the gathers in order)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(6, 8, dtype=F64, generator=gen)
    st = _sharded(x, spec)
    index = [(slice(None), slice(0, 5)), (slice(None), slice(3, 8)), (slice(None),)]
    near = [(0, 0), (0, 1), (1, 0)]
    coefs = [torch.randn(6, w, dtype=F64, generator=gen) for w in (5, 5, 8)]
    sink = TPC.GradSink({"x": st})
    train = TPC._Train(sink, 0.5)
    train.open_scope()
    with torch.enable_grad():
        outs = [TPC._WeightGather.apply(train.anchor, st, ix, CPU, nr, train.scope)
                for ix, nr in zip(index, near)]
        torch.autograd.backward(sum((o * c).sum() for o, c in zip(outs, coefs)))
    leaf = x.clone().requires_grad_()
    (0.5 * sum((leaf[ix] * c).sum() for ix, c in zip(index, coefs))).backward()
    for o, ix in zip(outs, index):
        assert torch.equal(o.detach(), x[ix])
    for pos in st.positions():
        acc = sink.acc[st][TPC.GradSink.key(st, pos)]
        assert acc.dtype == torch.float32
        want = leaf.grad[block_index(st.shape, st.sharding, pos)]
        _close(acc.double(), want, rel=1e-6)  # the float32 accumulator's rounding


def test_row_sum_backward_is_autograds():
    """Row-parallel partials through ``_RowSum`` (forward: the float32 sum in
    shard order; backward: the gradient handed to each partial) against
    the plain sum under autograd."""
    gen = torch.Generator().manual_seed(2)
    xs = [torch.randn(4, 3, dtype=torch.float32, generator=gen) for _ in range(3)]
    ws = [torch.randn(3, 5, dtype=torch.float32, generator=gen) for _ in range(3)]
    coef = torch.randn(4, 5, dtype=torch.float32, generator=gen)

    def run(join):
        leaves = [w.clone().requires_grad_() for w in ws]
        with torch.enable_grad():
            out = join([x @ w for x, w in zip(xs, leaves)])
            (out * coef).sum().backward()
        return out.detach(), [w.grad for w in leaves]

    got, got_g = run(lambda parts: TPC._RowSum.apply(CPU, *parts))
    want, want_g = run(lambda parts: parts[0] + parts[1] + parts[2])
    assert torch.equal(got, want)
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)


def test_broadcast_backward_is_autograds():
    """A replicated activation through ``_Broadcast`` to three shards, each
    using its copy (one not at all): the gradients (each the activation's
    dtype) summed in float32 in shard order and rounded once to that dtype,
    bit for bit, in float32 and in bfloat16."""
    gen = torch.Generator().manual_seed(3)
    x32 = torch.randn(4, 6, generator=gen)
    coefs = [torch.randn(4, 6, generator=gen) for _ in range(3)]
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype).clone().requires_grad_()
        with torch.enable_grad():
            outs = TPC._Broadcast.apply(x, CPU, CPU, CPU)
            loss = sum((o.float() * c).sum() for o, c in zip(outs[:2], coefs))
            loss.backward()
        want = (coefs[0].to(dtype).float() + coefs[1].to(dtype).float()).to(dtype)
        assert x.grad.dtype == dtype and torch.equal(x.grad, want)


def _pr32_count(cfg, shape_name, mesh):
    """Per-device FLOPs and bytes of the train step whose dp shards compute
    with whole gathered params (the dp-only design), from the port's own count:
    the step without a mesh counted on one dp part's rows (its FLOPs a
    device, and its live peak), plus what that design held beside it, the
    gathered whole params and a float32 accumulator of them."""
    import math

    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.steps import make_value_and_grad

    spec = SHAPES[shape_name]
    n_dp = math.prod(mesh.shape[a] for a in dp_axes(mesh))
    rows = spec.batch // spec.grad_accum // n_dp
    params = PT.init_params(cfg, None, device="meta")
    batch = {"tokens": torch.empty((rows, spec.seq), dtype=torch.long, device="meta"),
             "labels": torch.empty((rows, spec.seq), dtype=torch.long, device="meta")}
    with RL.StepAnalyzer() as a:
        make_value_and_grad(cfg, remat=True)(params, batch)
    whole = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    specs = input_specs(cfg, shape_name, mesh, fsdp=True)
    args = DR.arg_bytes(specs, mesh)
    out = DR.arg_bytes(specs[:2], mesh) + 4
    flops = a.metrics.flops * spec.grad_accum
    return flops, args + whole + 2 * whole + a.peak_bytes + out


def test_train_cell_splits_over_the_tensor_axis(monkeypatch):
    """A dense train cell at reduced width (qwen3-1.7b's shape: 4 layers,
    d_model 512, 16 / 8 heads of 64, d_ff 1536, vocab 8192, train_4k) on the
    16 x 16 meta mesh: a device's FLOPs fall by 12-16x against the dp-only
    design's (the products split over 16 tensor shards, but each of the 8
    kv heads is projected by the two shards that read it), and its bytes by
    more than half. That design's figures are counted here from the step
    without a mesh (``_pr32_count``)."""
    full = reduced_config("qwen3-1.7b", n_layers=4, d_model=512, n_heads=16, n_kv_heads=8,
                          d_head=64, d_ff=1536, vocab_size=8192, dtype="bfloat16")
    monkeypatch.setattr(DR, "get_config", lambda arch: full)
    row = DR.run_cell("qwen3-1.7b", "train_4k", "single")
    mesh = make_production_mesh(devices=[torch.device("meta")] * 256)
    flops, nbytes = _pr32_count(full, "train_4k", mesh)
    assert row["ok"] and row["fits"]
    print(f"FLOPs a device {row['flops']:.4e} against {flops:.4e} ({flops / row['flops']:.2f}x), "
          f"bytes {row['bytes_per_device']:.4e} against {nbytes:.4e} "
          f"({nbytes / row['bytes_per_device']:.2f}x)")
    assert 12 < flops / row["flops"] <= 16, (row["flops"], flops)
    assert row["bytes_per_device"] < nbytes / 2, (row["bytes_per_device"], nbytes)
    # one sampled part a layer: the forward, its recompute under remat, the backward
    assert row["launches"] == {"flash_attention/wgmma": 2 * full.n_layers,
                               "flash_attention_bwd/wgmma": full.n_layers}


def test_a_gather_with_no_path_to_the_loss_fails_finish():
    """A weight slice gathered in a scope whose gradient never arrives (its
    output unused) leaves the scope open: ``GradSink.finish`` raises rather
    than drop what the scope holds; once every gather's backward has run,
    it passes and the block took both gathers' gradients."""
    mesh = make_host_mesh(2, 2, devices=[CPU] * 4)
    st = shard(torch.arange(8.0).reshape(4, 2), NamedSharding(mesh, P("data", None)))
    for used in (False, True):
        sink = TPC.GradSink({"x": st})
        train = TPC._Train(sink, 1.0)
        train.open_scope()
        with torch.enable_grad():
            a, b = (TPC._WeightGather.apply(train.anchor, st, (slice(0, 4),), CPU, near,
                                            train.scope) for near in ((0, 0), (0, 1)))
            torch.autograd.backward((a + b).sum() if used else a.sum())
        if not used:
            with pytest.raises(RuntimeError, match="never drained"):
                sink.finish(lambda _, acc: acc)
            continue
        grads = sink.finish(lambda _, acc: acc)
        for pos in grads["x"].positions():
            assert torch.equal(grads["x"].block_at(pos), torch.full((2, 2), 2.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_over_blocks_is_the_whole_trees(seed):
    """``global_norm_blocks`` of a tree's distinct blocks on a 2 x 2 mesh
    (leaves split over one axis, both, or replicated; float32 and
    bfloat16) is ``global_norm`` of the whole leaves bit for bit."""
    rng = np.random.default_rng(seed)
    mesh = make_host_mesh(2, 2, devices=[CPU] * 4)
    specs = (P("data", None), P("data", "model"), P(), P(None, "model"))
    tree = {f"l{i}": torch.from_numpy(rng.standard_normal((6 + 2 * i, 4)).astype(np.float32)
                                      * 10.0 ** rng.integers(-3, 3)).to(dt)
            for i, dt in enumerate((torch.float32, torch.bfloat16) * 2)}
    blocks = []
    for x, sp in zip(tree.values(), specs):
        st = shard(x, NamedSharding(mesh, sp))
        blocks.append(list({TPC.GradSink.key(st, pos): st.block_at(pos)
                            for pos in st.positions()}.values()))
    assert [len(b) for b in blocks] == [2, 4, 1, 2]
    assert torch.equal(global_norm_blocks(blocks), global_norm(tree))
