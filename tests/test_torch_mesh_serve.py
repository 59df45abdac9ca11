"""The port's serving steps over a mesh against the JAX package's, on the CPU.

A mesh here is ``[cpu] * n``: n positions on one device, where the JAX side
forces 4 host devices (one subprocess for the module) and runs
``jax.jit(make_prefill_step(cfg))`` and then 3 ``jax.jit(make_decode_step(cfg))``
calls under ``with mesh, activation_sharding(mesh, shard_batch=b >= 16)`` on
params laid out by ``param_shardings``, the state by
``serve_state_shardings`` and the tokens by ``batch_specs`` /
``decode_token_tree``, as ``tests/test_sharding_small.py`` does. Float32
configs cut to 2 layers, on the port's ``init_params`` weights from a fixed
seed (handed to JAX as numpy arrays); a prompt of S tokens (frame
embeddings for musicgen-large) and 3 teacher-forced decode tokens from
numpy seeds, over a cache of MAX_LEN positions. The port runs the same
inputs on the same weights through ``make_prefill_step(cfg, mesh=)`` and
``make_decode_step(cfg, mesh=)``.

Limits, for six archs each on the 2 x 2 and the 1 x 4 mesh, at batch 4 on
one and 16 on the other (alternating from arch to arch, so that each mesh
runs both batches: a batch of 16 splits its rows and cache rows over the dp
axis, a batch of 4 splits the cache's sequence): qwen3-1.7b; qwen2.5-14b,
bias and one kv head, so its cache splits by sequence over the tensor axis
too; mixtral-8x22b, 4 experts over the shards, and 6 on the 1 x 4 mesh,
which splits each expert's d_ff; falcon-mamba-7b; hymba-1.5b, also with 6 /
3 heads and a vocabulary of 250 on the 1 x 4 mesh, which takes the ceil
split and the fallback layouts; musicgen-large on embeds; internvl2-76b on
patch embeddings on 2 x 2 at batch 4 (its one kv head at this size takes
the fallback layouts):
- every call's logits within 1e-5 of its largest |logit| (float32 sums in
  other orders: GSPMD keeps the unsharded step's semantics, so JAX's mesh
  step is its unsharded step up to those orders);
- every block of every state leaf within 1e-5 of the leaf's largest |value|
  of JAX's array at that block;
- the greedy tokens equal.

Bit for bit: a 1 x 1 mesh is the port's unsharded step, and a 2 x 1 mesh at
batch 16 is the port's unsharded step run over each dp shard's 8 rows.
At batch 4 a 2 x 1 mesh's cache is split by sequence over the dp axis, and
its decode merges the blocks (checked against JAX above, not bit for bit).

No position holds more than one layer's gathered params: every weight the
step gathers is freed before it gathers one of another layer.
"""
import dataclasses
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.launch import steps as PS
from repro_torch.launch import tp_compute as TPC
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import (batch_specs, block_index, param_shardings,
                                         serve_state_shardings, shard, shard_tree, unshard)
from repro_torch.launch.specs import decode_token_tree
from repro_torch.models import transformer as PT
from repro_torch.tree import path_key, tree_flatten_with_path, tree_replace_leaves

torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
S, MAX_LEN, N_DECODE = 32, 64, 3
ARCHS = ["qwen3-1.7b", "qwen2.5-14b", "mixtral-8x22b", "falcon-mamba-7b", "hymba-1.5b",
         "musicgen-large"]
CEIL = {"n_heads": 6, "n_kv_heads": 3, "vocab_size": 250}
# (arch, config overrides, data, model, batch): each arch on both meshes, its
# two batches crossed with them so that each arch and each mesh sees both
CASES = ([(a, {}, d, m, (4, 16)[(i + k) % 2]) for i, a in enumerate(ARCHS)
          for k, (d, m) in enumerate(((2, 2), (1, 4)))]
         + [("mixtral-8x22b", {"n_experts": 6}, 1, 4, 4), ("hymba-1.5b", CEIL, 1, 4, 4),
            ("internvl2-76b", {}, 2, 2, 4)])


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
from repro.configs import reduced_config
from repro.launch.act_sharding import activation_sharding
from repro.launch.mesh import make_host_mesh
from repro.launch.sharding import batch_specs, param_shardings, serve_state_shardings
from repro.launch.specs import decode_token_tree
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models import transformer as T

def flat_key(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

S, N_DECODE, MAX_LEN = SIZES_ARG
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
    name = "embeds" if cfg.frontend else "tokens"
    params = jax.device_put(params, param_shardings(cfg, mesh, fsdp=True))
    ssh = serve_state_shardings(cfg, mesh, b)
    state = T.init_serve_state(cfg, b, MAX_LEN)
    state = {k: (jax.device_put(v, ssh[k]) if k in ssh else v) for k, v in state.items()}
    batch = {name: jax.device_put(inp[:, :S], batch_specs(cfg, mesh, b, S, training=False)[name])}
    tsh = decode_token_tree(cfg, mesh, b).sharding
    with mesh, activation_sharding(mesh, shard_batch=b >= 16):
        logits, state = jax.jit(make_prefill_step(cfg, block_q=S))(params, batch, state)
        out[f"{cid}|logits|0"] = np.asarray(logits)
        step = jax.jit(make_decode_step(cfg))
        for t in range(N_DECODE):
            tok = jax.device_put(inp[:, S + t: S + t + 1], tsh)
            logits, state = step(params, tok, state)
            out[f"{cid}|logits|{t + 1}"] = np.asarray(logits)
    for k, x in state.items():
        if k != "length":
            out[f"{cid}|state|{k}"] = np.asarray(x)
np.savez(OUT_PATH, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX steps' logits and states of every case, on the port's seeded
    float32 weights and numpy-seeded inputs (both in the result too)."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    given = {}
    for i, (arch, over, _, _, b) in enumerate(CASES):
        cfg, key = _cfg(arch, over), _key(arch, over)
        if f"{key}|inputs" not in given:
            params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            given.update({f"{key}|init|{path_key(p)}": x.numpy()
                          for p, x in tree_flatten_with_path(params)})
            given[f"{key}|inputs"] = None
        given[f"{_case_id(CASES[i])}|inputs"] = _inputs(cfg, b, 100 + i).numpy()
    given = {k: v for k, v in given.items() if v is not None}
    np.savez(tmp / "in.npz", **given)
    code = (JAX_SCRIPT.replace("SRC_PATH", repr(SRC)).replace("IN_PATH", repr(str(tmp / "in.npz")))
            .replace("OUT_PATH", repr(str(tmp / "out.npz"))).replace("CASES_ARG", repr(CASES))
            .replace("SIZES_ARG", repr((S, N_DECODE, MAX_LEN))))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(tmp / "out.npz") as data:
        return {**given, **data}


def _cfg(arch, over):
    return dataclasses.replace(reduced_config(arch, n_layers=2, **over), dtype="float32")


def _given_params(jax_run, key, cfg):
    meta = PT.init_params(cfg, None, device="meta")
    return tree_replace_leaves(meta, [bridge.tensor_from_numpy(jax_run[f"{key}|init|"
                                                                       f"{path_key(p)}"], "cpu")
                                      for p, _ in tree_flatten_with_path(meta)])


def _inputs(cfg, b, seed):
    """A prompt of S positions and N_DECODE decode inputs (b, 1[, d])."""
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        inp = (cfg.d_model ** -0.5 * rng.standard_normal(
            (b, S + N_DECODE, cfg.d_model))).astype(np.float32)
    else:
        inp = rng.integers(0, cfg.vocab_size, (b, S + N_DECODE)).astype(np.int32)
    return torch.from_numpy(inp)


def _mesh_run(cfg, params, inp, data, model):
    """The mesh steps on ``inp``: (logits of the prefill and each decode
    step, the state with its blocks)."""
    b = inp.shape[0]
    mesh = make_host_mesh(data, model, devices=[CPU] * (data * model))
    ps = shard_tree(params, param_shardings(cfg, mesh, fsdp=True))
    ssh = serve_state_shardings(cfg, mesh, b)
    state = {k: (v if k == "length" else shard(v, ssh[k]))
             for k, v in PT.init_serve_state(cfg, b, MAX_LEN, device="cpu").items()}
    name = "embeds" if cfg.frontend else "tokens"
    batch = {name: shard(inp[:, :S], batch_specs(cfg, mesh, b, S, training=False)[name])}
    tsh = decode_token_tree(cfg, mesh, b).sharding
    logits, state = PS.make_prefill_step(cfg, mesh=mesh)(ps, batch, state)
    out = [logits]
    step = PS.make_decode_step(cfg, mesh=mesh)
    for t in range(N_DECODE):
        logits, state = step(ps, shard(inp[:, S + t: S + t + 1], tsh), state)
        out.append(logits)
    return out, state


def _plain_run(cfg, params, inp):
    """The unsharded steps on ``inp``."""
    name = "embeds" if cfg.frontend else "tokens"
    state = PT.init_serve_state(cfg, inp.shape[0], MAX_LEN, device="cpu")
    logits, state = PS.make_prefill_step(cfg)(params, {name: inp[:, :S]}, state)
    out = [logits]
    for t in range(N_DECODE):
        logits, state = PS.make_decode_step(cfg)(params, inp[:, S + t: S + t + 1], state)
        out.append(logits)
    return out, state


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_mesh_steps_match_jax(jax_run, case):
    arch, over, data, model, b = case
    cid = _case_id(case)
    key = _key(arch, over)
    cfg = _cfg(arch, over)
    inp = torch.from_numpy(jax_run[f"{cid}|inputs"])
    logits, state = _mesh_run(cfg, _given_params(jax_run, key, cfg), inp, data, model)
    for i, got in enumerate(logits):
        want = jax_run[f"{cid}|logits|{i}"]
        assert got.device == CPU and tuple(got.shape) == want.shape
        got = got.numpy()
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (i, err, np.abs(want).max())
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert state["length"] == S + N_DECODE
    for name in ("k", "v", "ssm_h", "ssm_conv"):
        if f"{cid}|state|{name}" not in jax_run:
            assert name not in state
            continue
        want, st = jax_run[f"{cid}|state|{name}"], state[name]
        limit = 1e-5 * np.abs(want).max()
        for pos in st.positions():
            sl = block_index(st.shape, st.sharding, pos)
            assert np.abs(st.block_at(pos).numpy() - want[sl]).max() <= limit, (name, pos)


@pytest.mark.parametrize("data,b", [(1, 4), (1, 16), (2, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_and_dp_only_are_the_unsharded_step(arch, data, b):
    """1 x 1: the unsharded steps; 2 x 1 at batch 16: the unsharded steps over
    each dp shard's rows. Logits and every state block bit for bit."""
    cfg = _cfg(arch, {})
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    inp = _inputs(cfg, b, 7)
    got, state = _mesh_run(cfg, params, inp, data, 1)
    r = b // data
    for j in range(data):
        rows = slice(j * r, (j + 1) * r)
        want, want_state = _plain_run(cfg, params, inp[rows])
        for g, w in zip(got, want):
            assert torch.equal(g[rows], w)
        for name, st in state.items():
            if name == "length":
                continue
            whole = unshard(st, CPU)
            assert torch.equal(whole[:, rows], want_state[name]), name


@pytest.mark.parametrize("arch,data,model,b", [("hymba-1.5b", 2, 2, 16),
                                               ("mixtral-8x22b", 2, 2, 4)])
def test_no_position_holds_two_layers(monkeypatch, arch, data, model, b):
    """Every weight the steps gather (a slice of one layer of a stacked leaf)
    is freed before any of another layer is gathered: a position holds one
    layer's gathered params at a time."""
    cfg = _cfg(arch, {})
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    live, seen = [], set()
    real = TPC.gather_slice

    def tracking(st, index, device, near):
        out, n, remote = real(st, index, device, near)
        if st.shape[0] == cfg.n_layers and index[0].stop - index[0].start == 1:
            layer = index[0].start
            live[:] = [(l, r) for l, r in live if r() is not None]
            assert all(l == layer for l, _ in live), (layer, [l for l, _ in live])
            if out._base is None:  # a copy (a view of the position's own block is no gather)
                live.append((layer, weakref.ref(out.untyped_storage())))
                seen.add(layer)
        return out, n, remote

    monkeypatch.setattr(TPC, "gather_slice", tracking)
    _mesh_run(cfg, params, _inputs(cfg, b, 3), data, model)
    assert seen == set(range(cfg.n_layers))
