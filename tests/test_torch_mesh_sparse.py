"""The port's ContiguousKV sparse decode step over a mesh against the JAX
package's, on the CPU.

A mesh here is ``[cpu] * n``: n positions on one device, where the JAX side
forces 4 host devices (one subprocess for the module) and, as
``tests/test_sharding_small.py``'s ``test_sparse_decode_on_mesh`` does, runs
``jax.jit(make_sparse_decode_step(cfg, chunk_tokens=8, budget=0.25,
cached_summaries=...))`` under ``with mesh, activation_sharding(mesh,
shard_batch=b >= 16)`` on params laid out by ``param_shardings``, the state
by ``serve_state_shardings`` (``kmean`` on k's spec) and the tokens by
``decode_token_tree``. Float32 configs cut to 2 layers, on the port's
``init_params`` weights from a fixed seed (handed to JAX as numpy arrays):
the mesh prefill of S prompt tokens into a cache of MAX_LEN positions, the
chunk summaries built from the prefilled cache (the mean of each chunk's
keys, as ``tests/test_torch_sharded.py``'s ``sparse_model`` builds them),
then N_DECODE teacher-forced sparse steps. The port runs the same inputs on
the same weights through ``make_prefill_step(cfg, mesh=)`` and
``make_sparse_decode_step(cfg, ..., mesh=)``.

Limits, for qwen3-1.7b, qwen2.5-14b (one kv head: its cache splits by
sequence over the tensor axis too) and mixtral-8x22b (the dropless MoE FFN)
each on the 2 x 2 and the 1 x 4 mesh, at batch 4 on one and 16 on the
other, and qwen3-1.7b with 6 / 3 heads and a vocabulary of 250 on 1 x 4 (the
ceil split), and internvl2-76b on patch embeddings on 1 x 4 at batch 4,
each without and with cached summaries; those of
``tests/test_torch_mesh_serve.py``:
- every step's logits within 1e-5 of its largest |logit|;
- every block of k, v and kmean within 1e-5 of the leaf's largest |value|
  of JAX's array at that block;
- the greedy tokens equal;
- every (step, layer, row) pick (recorded through ``steps.top_chunks``)
  equal to the unsharded float32 step's on the same inputs.

Once, the budget-0.25 logits lie more than 100x that limit from the
budget-1.0 logits, so a wrong pick cannot pass; budget 1.0 over a mesh is
the mesh's dense decode step within it. Bit for bit: a 1 x 1 mesh is the
unsharded sparse step, and a 2 x 1 mesh at batch 16 the unsharded step
over each dp shard's 8 rows. A capacity whose blocks split a chunk, or
chunk summaries laid out off k's blocks, raise ValueError with the state
unwritten; ``make_sharded_sparse_decode_step`` over a laid-out state is bit
for bit the same step over whole tensors.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharded_sparse import make_sharded_sparse_decode_step
from repro_torch.launch.sharding import (NamedSharding, P, batch_specs, block_index,
                                         param_shardings, serve_state_shardings, shard, shard_tree,
                                         unshard)
from repro_torch.launch.specs import decode_token_tree
from repro_torch.models import transformer as PT
from repro_torch.tree import path_key, tree_flatten_with_path, tree_replace_leaves

CPU = torch.device("cpu")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
S, MAX_LEN, N_DECODE, C, BUDGET = 32, 64, 3, 8, 0.25
LIMIT = 1e-5
ARCHS = ["qwen3-1.7b", "qwen2.5-14b", "mixtral-8x22b"]
CEIL = {"n_heads": 6, "n_kv_heads": 3, "vocab_size": 250}
# (arch, config overrides, data, model, batch): each arch on both meshes, its
# two batches crossed with them so that each arch and each mesh sees both
CASES = ([(a, {}, d, m, (4, 16)[(i + k) % 2]) for i, a in enumerate(ARCHS)
          for k, (d, m) in enumerate(((2, 2), (1, 4)))]
         + [("qwen3-1.7b", CEIL, 1, 4, 4), ("internvl2-76b", {}, 1, 4, 4)])


def _key(arch, over):
    return arch + "".join(f"~{k}{v}" for k, v in sorted(over.items()))


def _case_id(case):
    arch, over, d, m, b = case
    return f"{_key(arch, over)}-{d}x{m}-b{b}"


JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC_PATH)
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import reduced_config
from repro.launch.act_sharding import activation_sharding
from repro.launch.mesh import make_host_mesh
from repro.launch.sharding import batch_specs, param_shardings, serve_state_shardings
from repro.launch.specs import decode_token_tree
from repro.launch.steps import make_prefill_step, make_sparse_decode_step
from repro.models import transformer as T

def flat_key(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

S, N_DECODE, MAX_LEN, C, BUDGET = SIZES_ARG
assert jax.device_count() == 4
data = dict(np.load(IN_PATH))
out = {}
for arch, over, dp, tp, b in CASES_ARG:
    key = arch + "".join(f"~{k}{v}" for k, v in sorted(over.items()))
    cid = f"{key}-{dp}x{tp}-b{b}"
    cfg = dataclasses.replace(reduced_config(arch, n_layers=2, **over), dtype="float32")
    shapes = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(data[f"{key}|init|{flat_key(p)}"], x.dtype), shapes)
    mesh = make_host_mesh(dp, tp)
    inp = data[f"{cid}|inputs"]
    params = jax.device_put(params, param_shardings(cfg, mesh, fsdp=True))
    ssh = serve_state_shardings(cfg, mesh, b)
    state = T.init_serve_state(cfg, b, MAX_LEN)
    state = {k: (jax.device_put(v, ssh[k]) if k in ssh else v) for k, v in state.items()}
    name = "embeds" if cfg.frontend else "tokens"
    batch = {name: jax.device_put(inp[:, :S], batch_specs(cfg, mesh, b, S, training=False)[name])}
    tsh = decode_token_tree(cfg, mesh, b).sharding
    with mesh, activation_sharding(mesh, shard_batch=b >= 16):
        _, prefilled = jax.jit(make_prefill_step(cfg, block_q=S))(params, batch, state)
    for cached in (False, True):
        state = dict(prefilled)
        if cached:
            L, n_kv, d = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
            kmean = state["k"].reshape(L, b, MAX_LEN // C, C, n_kv, d).mean(axis=3)
            state["kmean"] = jax.device_put(kmean, NamedSharding(mesh, ssh["k"].spec))
        step = jax.jit(make_sparse_decode_step(cfg, chunk_tokens=C, budget=BUDGET,
                                               cached_summaries=cached))
        with mesh, activation_sharding(mesh, shard_batch=b >= 16):
            for t in range(N_DECODE):
                tok = jax.device_put(inp[:, S + t: S + t + 1], tsh)
                logits, state = step(params, tok, state)
                out[f"{cid}|{cached}|logits|{t}"] = np.asarray(logits)
        for k, x in state.items():
            if k != "length":
                out[f"{cid}|{cached}|state|{k}"] = np.asarray(x)
np.savez(OUT_PATH, **out)
print("OK")
"""


def _cfg(arch, over):
    return dataclasses.replace(reduced_config(arch, n_layers=2, **over), dtype="float32")


def _inputs(cfg, b, seed):
    """A prompt of S tokens and N_DECODE decode tokens, (b, S + N_DECODE);
    for a frontend config S + N_DECODE embeddings, (b, S + N_DECODE, d)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        return torch.from_numpy((cfg.d_model ** -0.5 * rng.standard_normal(
            (b, S + N_DECODE, cfg.d_model))).astype(np.float32))
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, S + N_DECODE)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX sparse steps' logits and states of every case and both
    summary modes, on the port's seeded float32 weights and numpy-seeded
    inputs (both in the result too)."""
    tmp = tmp_path_factory.mktemp("mesh_sparse")
    given = {}
    for i, (arch, over, _, _, b) in enumerate(CASES):
        cfg, key = _cfg(arch, over), _key(arch, over)
        if not any(k.startswith(f"{key}|init|") for k in given):
            params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            given.update({f"{key}|init|{path_key(p)}": x.numpy()
                          for p, x in tree_flatten_with_path(params)})
        given[f"{_case_id(CASES[i])}|inputs"] = _inputs(cfg, b, 200 + i).numpy()
    np.savez(tmp / "in.npz", **given)
    code = (JAX_SCRIPT.replace("SRC_PATH", repr(SRC)).replace("IN_PATH", repr(str(tmp / "in.npz")))
            .replace("OUT_PATH", repr(str(tmp / "out.npz"))).replace("CASES_ARG", repr(CASES))
            .replace("SIZES_ARG", repr((S, N_DECODE, MAX_LEN, C, BUDGET))))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(tmp / "out.npz") as data:
        return {**given, **data}


def _given_params(jax_run, key, cfg):
    meta = PT.init_params(cfg, None, device="meta")
    return tree_replace_leaves(meta, [bridge.tensor_from_numpy(
        jax_run[f"{key}|init|{path_key(p)}"], "cpu") for p, _ in tree_flatten_with_path(meta)])


def _summaries(cfg, k):
    """Each chunk's mean key, (L, b, m, n_kv, d), from a cache (L, b, S, n_kv, d)."""
    L, b, cap = k.shape[:3]
    return k.reshape(L, b, cap // C, C, cfg.n_kv_heads, cfg.d_head).mean(dim=3)


class Picks:
    """Every pick ``steps.top_chunks`` returns while entered, in call order."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = PS.top_chunks

        def recording(scores, k):
            out = real(scores, k)
            self.calls.append(out.clone())
            return out

        monkeypatch.setattr(PS, "top_chunks", recording)

    def by_step_layer(self, cfg, parts: int):
        """The picks of each (step, layer), the dp parts' rows joined."""
        L = cfg.n_layers
        assert len(self.calls) == N_DECODE * parts * L
        return [torch.cat([self.calls[(t * parts + j) * L + l] for j in range(parts)])
                for t in range(N_DECODE) for l in range(L)]


def _mesh_run(cfg, params, inp, data, model, cached, budget=BUDGET, dense=False):
    """The mesh prefill and N_DECODE sparse steps (or, ``dense``, decode
    steps) on ``inp``: (the steps' logits, the state with its blocks)."""
    b = inp.shape[0]
    mesh = make_host_mesh(data, model, devices=[CPU] * (data * model))
    ps = shard_tree(params, param_shardings(cfg, mesh, fsdp=True))
    ssh = serve_state_shardings(cfg, mesh, b)
    state = {k: (v if k == "length" else shard(v, ssh[k]))
             for k, v in PT.init_serve_state(cfg, b, MAX_LEN, device="cpu").items()}
    name = "embeds" if cfg.frontend else "tokens"
    batch = {name: shard(inp[:, :S], batch_specs(cfg, mesh, b, S, training=False)[name])}
    _, state = PS.make_prefill_step(cfg, mesh=mesh)(ps, batch, state)
    if cached:
        state["kmean"] = shard(_summaries(cfg, unshard(state["k"], CPU)),
                               NamedSharding(mesh, ssh["k"].spec))
    step = (PS.make_decode_step(cfg, mesh=mesh) if dense else PS.make_sparse_decode_step(
        cfg, chunk_tokens=C, budget=budget, cached_summaries=cached, mesh=mesh))
    tsh = decode_token_tree(cfg, mesh, b).sharding
    out = []
    for t in range(N_DECODE):
        logits, state = step(ps, shard(inp[:, S + t: S + t + 1], tsh), state)
        out.append(logits)
    return out, state


def _plain_run(cfg, params, inp, cached):
    """The unsharded prefill and N_DECODE sparse steps on ``inp``."""
    state = PT.init_serve_state(cfg, inp.shape[0], MAX_LEN, device="cpu")
    _, state = PS.make_prefill_step(cfg)(
        params, {"embeds" if cfg.frontend else "tokens": inp[:, :S]}, state)
    if cached:
        state["kmean"] = _summaries(cfg, state["k"])
    step = PS.make_sparse_decode_step(cfg, chunk_tokens=C, budget=BUDGET, cached_summaries=cached)
    out = []
    for t in range(N_DECODE):
        logits, state = step(params, inp[:, S + t: S + t + 1], state)
        out.append(logits)
    return out, state


def _within(got, want):
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= LIMIT * top, (err, top)


@pytest.mark.parametrize("cached", [False, True], ids=["kmeans", "summaries"])
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_mesh_sparse_step_matches_jax(jax_run, monkeypatch, case, cached):
    arch, over, data, model, b = case
    cid, key, cfg = _case_id(case), _key(arch, over), _cfg(arch, over)
    params = _given_params(jax_run, key, cfg)
    inp = torch.from_numpy(jax_run[f"{cid}|inputs"])
    picks = Picks(monkeypatch)
    logits, state = _mesh_run(cfg, params, inp, data, model, cached)
    for t, got in enumerate(logits):
        want = jax_run[f"{cid}|{cached}|logits|{t}"]
        assert got.device == CPU and tuple(got.shape) == want.shape
        _within(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    assert state["length"] == S + N_DECODE
    names = ("k", "v") + (("kmean",) if cached else ())
    assert set(state) == {"length", *names}
    for name in names:
        want, st = jax_run[f"{cid}|{cached}|state|{name}"], state[name]
        for pos in st.positions():
            sl = block_index(st.shape, st.sharding, pos)
            assert np.abs(st.block_at(pos).numpy() - want[sl]).max() <= (
                LIMIT * np.abs(want).max()), (name, pos)
    # the same picks as the unsharded float32 step on the same inputs
    mesh_picks = picks.by_step_layer(cfg, data if b >= 16 and data > 1 else 1)
    picks.calls.clear()
    _plain_run(cfg, params, inp, cached)
    plain_picks = picks.by_step_layer(cfg, 1)
    for got, want in zip(mesh_picks, plain_picks):
        assert torch.equal(got, want)


@pytest.mark.parametrize("data,model,b", [(2, 2, 4), (1, 4, 16)])
@pytest.mark.parametrize("cached", [False, True], ids=["kmeans", "summaries"])
def test_budget_one_over_a_mesh_is_the_dense_decode(cached, data, model, b):
    """Budget 1.0 picks every chunk: the mesh's dense decode step within the
    limit. Budget 0.25 lies more than 100x the limit from it."""
    cfg = _cfg("qwen3-1.7b", {})
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    inp = _inputs(cfg, b, 11)
    dense, _ = _mesh_run(cfg, params, inp, data, model, cached, dense=True)
    full, _ = _mesh_run(cfg, params, inp, data, model, cached, budget=1.0)
    sparse, _ = _mesh_run(cfg, params, inp, data, model, cached)
    for d, f, s in zip(dense, full, sparse):
        _within(f.numpy(), d.numpy())
        assert (s - d).abs().max() > 100 * LIMIT * d.abs().max()


@pytest.mark.parametrize("cached", [False, True], ids=["kmeans", "summaries"])
@pytest.mark.parametrize("data,b", [(1, 4), (1, 16), (2, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_and_dp_only_are_the_unsharded_step(arch, data, b, cached):
    """1 x 1: the unsharded sparse step; 2 x 1 at batch 16: the unsharded
    step over each dp shard's rows. Logits and every state block bit for
    bit."""
    cfg = _cfg(arch, {})
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    inp = _inputs(cfg, b, 7)
    got, state = _mesh_run(cfg, params, inp, data, 1, cached)
    r = b // data
    for j in range(data):
        rows = slice(j * r, (j + 1) * r)
        want, want_state = _plain_run(cfg, params, inp[rows], cached)
        for g, w in zip(got, want):
            assert torch.equal(g[rows], w)
        for name, st in state.items():
            if name != "length":
                assert torch.equal(unshard(st, CPU)[:, rows], want_state[name]), name


@pytest.mark.parametrize("fault", ["capacity", "summaries"])
def test_blocks_that_split_a_chunk_are_refused_unwritten(fault):
    """2 x 2 at batch 4 splits the cache's sequence over the data axis: a
    capacity of 40 gives blocks of 20 positions, which split the 8-token
    chunks; chunk summaries laid out whole (replicated) do not hold the
    chunks of k's blocks. Each raises ValueError before any block is
    written."""
    cfg = _cfg("qwen3-1.7b", {})
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = make_host_mesh(2, 2, devices=[CPU] * 4)
    b, cached = 4, fault == "summaries"
    cap = MAX_LEN if cached else 40
    ssh = serve_state_shardings(cfg, mesh, b)
    g = torch.Generator().manual_seed(1)
    whole = {k: torch.randn(cfg.n_layers, b, cap, cfg.n_kv_heads, cfg.d_head, generator=g)
             for k in ("k", "v")}
    state = {k: shard(v, ssh[k]) for k, v in whole.items()}
    if cached:
        state["kmean"] = shard(_summaries(cfg, whole["k"]), NamedSharding(mesh, P()))
    state["length"] = 16
    before = {k: [x.clone() for x in v.blocks.flat] for k, v in state.items() if k != "length"}
    step = PS.make_sparse_decode_step(cfg, chunk_tokens=C, budget=BUDGET,
                                      cached_summaries=cached, mesh=mesh)
    match = "kmean's blocks" if cached else "hold whole ContiguousChunks"
    with pytest.raises(ValueError, match=match):
        step(shard_tree(params, param_shardings(cfg, mesh, fsdp=True)),
             shard(torch.zeros(b, 1, dtype=torch.int32), decode_token_tree(cfg, mesh, b).sharding),
             state)
    assert state["length"] == 16
    for k, blocks in before.items():
        assert all(torch.equal(x, y) for x, y in zip(blocks, state[k].blocks.flat)), k


@pytest.mark.parametrize("laid_params", [False, True], ids=["whole_params", "laid_params"])
@pytest.mark.parametrize("b", [4, 16])
def test_sharded_sparse_step_over_a_laid_out_state_is_the_whole_tensor_step(b, laid_params):
    """``make_sharded_sparse_decode_step`` on a 2 x 2 mesh, 3 steps over k,
    v and kmean laid out as ``input_specs(..., sparse_summaries=True)`` lays
    them (batch 4: the sequence over the data axis, kv heads over the model
    axis; batch 16: rows over the data axis), params whole or laid out by
    ``param_shardings``: logits and every state leaf bit for bit the same
    step over whole tensors."""
    cfg = _cfg("qwen3-1.7b", {})
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = make_host_mesh(2, 2, devices=[CPU] * 4)
    g = torch.Generator().manual_seed(2)
    whole = {k: torch.randn(cfg.n_layers, b, MAX_LEN, cfg.n_kv_heads, cfg.d_head, generator=g)
             for k in ("k", "v")}
    whole["kmean"] = _summaries(cfg, whole["k"])
    whole["length"] = 29
    ssh = serve_state_shardings(cfg, mesh, b)
    laid = {k: shard(v, NamedSharding(mesh, ssh["k"].spec)) for k, v in whole.items()
            if k != "length"}
    laid["length"] = 29
    ps = shard_tree(params, param_shardings(cfg, mesh, fsdp=True)) if laid_params else params
    tsh = decode_token_tree(cfg, mesh, b).sharding
    step = make_sharded_sparse_decode_step(cfg, mesh, chunk_tokens=C, budget=0.5)
    for t in range(N_DECODE):
        tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=g, dtype=torch.int32)
        want, whole = step(params, tok, whole)
        got, laid = step(ps, shard(tok, tsh), laid)
        assert torch.equal(got, want)
    assert laid["length"] == whole["length"] == 29 + N_DECODE
    for k in ("k", "v", "kmean"):
        assert torch.equal(unshard(laid[k], CPU), whole[k]), k
