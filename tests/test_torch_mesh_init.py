"""The laid-out init and the kernel wrappers' device guard, on the CPU.

``init_params(cfg, generator, device, shardings=)`` makes the params
straight into their blocks on a mesh: it must be bit for bit
``shard_tree(init_params(cfg, generator, device), shardings)``, block by
block, for every family on 1 x 4, 2 x 2 and 2 x 1 meshes of ``[cpu] * 4``
(reduced configs: the random draws are the same whatever the width). It
draws what ``init_params`` draws, in the same order, one layer of a stacked
leaf at a time (checked by recording ``torch.randn``), and allocates no
tensor but the blocks (checked by recording ``torch.empty``).

Every CUDA route of the kernels' ``ops.py`` runs under
``build.on_own_device``, which makes its tensors' device current; a call on
CPU tensors runs the plain version with no device entered.
"""
import math

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import build as B
from repro_torch.kernels.chunk_attention import ops as ca
from repro_torch.kernels.chunk_score import ops as cs
from repro_torch.kernels.chunk_score.ref import chunk_score_ref
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.selective_scan import ops as ss
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import ShardedTensor, block_index, param_shardings, shard_tree
from repro_torch.models import transformer as PT
from repro_torch.tree import tree_flatten_with_path

CPU = torch.device("cpu")
ARCHS = ["qwen3-1.7b", "internvl2-76b", "mixtral-8x22b", "falcon-mamba-7b"]
MESHES = [(1, 4), (2, 2), (2, 1)]
ENTRY_POINTS = [cs.chunk_score, ca.chunk_attention, ca.chunk_attention_indexed,
                da.decode_attention, da.decode_attention_pools, fa.flash_attention,
                fa.flash_attention_bwd, ss.selective_scan, ss.selective_scan_bwd]


def _shardings(cfg, data, model):
    mesh = make_host_mesh(data, model, devices=[CPU] * 4)
    return param_shardings(cfg, mesh, fsdp=True)


@pytest.mark.parametrize("data,model", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_laid_out_init_is_shard_tree_of_init_params(arch, data, model):
    cfg = reduced_config(arch)
    sh = _shardings(cfg, data, model)
    want = shard_tree(PT.init_params(cfg, torch.Generator().manual_seed(5), "cpu"), sh)
    got = PT.init_params(cfg, torch.Generator().manual_seed(5), "cpu", shardings=sh)
    w_leaves, g_leaves = tree_flatten_with_path(want), tree_flatten_with_path(got)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, w), (_, g) in zip(w_leaves, g_leaves):
        assert isinstance(g, ShardedTensor), path
        assert (g.shape, g.dtype, g.sharding) == (w.shape, w.dtype, w.sharding), path
        for pos in w.positions():
            a, b = g.block_at(pos), w.block_at(pos)
            assert a.dtype == b.dtype and torch.equal(a, b), (path, pos)
            assert a.is_contiguous()


@pytest.mark.parametrize("arch", ARCHS)
def test_laid_out_init_draws_a_layer_at_a_time(monkeypatch, arch):
    """The draws are init_params' own, in order; a stacked leaf's are one
    layer each, so the largest is one layer's float32 slice of a leaf (or
    a leaf drawn whole, the embedding); the only tensors allocated are the
    stacked leaves' blocks."""
    cfg = reduced_config(arch)
    sh = _shardings(cfg, 2, 2)
    draws, empties = [], []
    randn, empty = torch.randn, torch.empty

    def record_randn(*args, **kw):
        out = randn(*args, **kw)
        draws.append((tuple(out.shape), out.dtype))
        return out

    def record_empty(*args, **kw):
        out = empty(*args, **kw)
        empties.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "randn", record_randn)
    PT.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    plain = list(draws)
    draws.clear()
    monkeypatch.setattr(torch, "empty", record_empty)
    got = PT.init_params(cfg, torch.Generator().manual_seed(5), "cpu", shardings=sh)
    monkeypatch.undo()
    assert draws == plain and all(dtype == torch.float32 for _, dtype in draws)
    leaves = tree_flatten_with_path(got)
    # the drawn leaves: those another seed changes
    seeds = [dict(tree_flatten_with_path(PT.init_params(cfg, torch.Generator().manual_seed(n),
                                                        "cpu"))) for n in (5, 6)]
    drawn = {p for p, x in seeds[0].items() if not torch.equal(x, seeds[1][p])}
    stacked = [x for p, x in leaves if p[0] == "layers" and p in drawn]
    whole = [tuple(x.shape) for p, x in leaves if p[0] in ("embed", "unembed")]
    assert len(draws) == cfg.n_layers * len(stacked) + len(whole)
    assert [shape for shape, _ in draws[-len(whole):]] == whole  # embed, then unembed
    layer_shapes = {tuple(x.shape[1:]) for x in stacked}
    assert all(shape in layer_shapes for shape, _ in draws[:-len(whole)])
    blocks = sorted(tuple(sl.stop - sl.start for sl in block_index(x.shape, x.sharding, pos))
                    for x in stacked for pos in x.positions())
    assert sorted(empties) == blocks


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_every_cuda_route_runs_under_its_tensors_device(fn):
    assert fn.__code__ is B.on_own_device(lambda: None).__code__
    assert fn.__wrapped__.__module__ == fn.__module__


def test_device_guard_is_a_no_op_on_cpu_tensors(monkeypatch):
    """CPU calls give the plain versions' bits and enter no device."""
    def refuse(*args, **kw):
        raise AssertionError("a CPU call entered a CUDA device")

    monkeypatch.setattr(torch.cuda, "device", refuse)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(8, 4, 32, generator=gen)
    k = torch.randn(40, 2, 32, generator=gen).to(torch.float16)
    assert torch.equal(cs.chunk_score(q, k, 16), chunk_score_ref(q, k, 16))
    qf, kf, vf = (torch.randn(1, h, 24, 16, generator=gen) for h in (4, 2, 2))
    assert torch.equal(fa.flash_attention(qf, kf, vf), flash_attention_ref(qf, kf, vf))
    x, dt = torch.randn(1, 12, 6, generator=gen), torch.rand(1, 12, generator=gen)
    A = -torch.rand(6, 4, generator=gen)
    Bm, Cm = torch.randn(1, 12, 4, generator=gen), torch.randn(1, 12, 4, generator=gen)
    got, want = ss.selective_scan(x, dt, A, Bm, Cm), selective_scan_ref(x, dt, A, Bm, Cm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
