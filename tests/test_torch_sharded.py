"""The port's tensor-parallel decode against the JAX package's, on the CPU.

A mesh here is ``[cpu] * k``: k shards on one device, where the JAX tests
force k host devices. Float32 configs on numpy-seeded inputs. Limits:
- the mesh builders and axis helpers give JAX's answers (axis names,
  shapes, errors), JAX's taken with 4 forced host devices;
- the sharded paged attend on 8 shards, flat and with kv_split 2, against
  JAX's ``decode_attention(..., use_kernel=False)`` on JAX's own test inputs:
  out and mass within 1e-5, pad-slot mass exactly 0, each row's mass summing
  to 1 within 1e-5;
- the sharded sparse step on a 2 x 2 mesh against JAX's on 4 forced host
  devices (one subprocess): logits within 1e-5, the new state's k, v and
  kmean within 1e-6, each of its tensor's largest element (the appended
  token's K and V come out of the two packages' projections, float32 sums in
  other orders), and its length equal;
- ``RealCompute(tp_mesh=...)`` on 1 and 4 shards against the JAX backend
  without a mesh, through ``decode_attend`` and ``decode_step_batch``: the
  same greedy tokens, logits within 1e-5 of the largest.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core.backends import DeviceTailPool as JaxDeviceTailPool
from repro.core.backends import RealCompute as JaxCompute
from repro.core.stepplan import DecodeBatchCtx as JaxCtx
from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.launch import mesh as jax_mesh
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.backends import DeviceTailPool, RealCompute, TailPool
from repro_torch.core.stepplan import DecodeBatchCtx
from repro_torch.launch import mesh as M
from repro_torch.launch.sharded_sparse import (combine_partials, make_sharded_paged_decode,
                                               make_sharded_sparse_decode_step)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

# JAX on 4 forced host devices: its mesh answers and its sharded sparse step
# at budgets 0.5 and 1.0 over a prefilled state of qwen3-1.7b (reduced,
# float32), written to an .npz; the params' leaves go too, in tree order
JAX_SCRIPT = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC_PATH)
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import reduced_config
from repro.launch import mesh as M
from repro.launch.sharded_sparse import make_sharded_sparse_decode_step
from repro.models import transformer as T

assert jax.device_count() == 4
answers = {}
for name, fn in (("serving0", lambda: M.make_serving_mesh()),
                 ("serving2", lambda: M.make_serving_mesh(kv_split=2)),
                 ("serving4", lambda: M.make_serving_mesh(kv_split=4)),
                 ("host22", lambda: M.make_host_mesh(2, 2)),
                 ("host14", lambda: M.make_host_mesh(1, 4))):
    m = fn()
    answers[name] = {"axis_names": list(m.axis_names), "shape": dict(m.shape),
                     "size": int(m.devices.size), "tp": list(M.tp_axes(m)),
                     "kv": list(M.kv_axes(m)), "dp": list(M.dp_axes(m))}
for k in (3, -2):
    try:
        M.make_serving_mesh(kv_split=k)
    except ValueError as e:
        answers[f"error{k}"] = str(e)

cfg = dataclasses.replace(reduced_config("qwen3-1.7b", n_layers=2), dtype="float32")
mesh = M.make_host_mesh(2, 2)
params = T.init_params(jax.random.PRNGKey(0), cfg)
b, ctx, cap, c = 2, 48, 64, 8
rng = np.random.default_rng(3)
state = T.init_serve_state(cfg, b, cap)
toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (b, ctx)).astype(np.int32))
_, state = T.prefill(params, {"tokens": toks}, cfg, state, block_q=16)
kc = np.asarray(state["k"]).reshape(cfg.n_layers, b, cap // c, c, cfg.n_kv_heads, cfg.d_head)
state["kmean"] = jnp.asarray(kc.mean(axis=3))
tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
out = {f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree_util.tree_leaves(params))}
out.update({f"s_{k}": np.asarray(state[k]) for k in ("k", "v", "kmean", "length")})
out["token"] = tok
with mesh:
    for budget in (0.5, 1.0):
        step = make_sharded_sparse_decode_step(cfg, mesh, chunk_tokens=c, budget=budget)
        logits, st = jax.jit(step)(params, jnp.asarray(tok), state)
        out[f"logits{budget}"] = np.asarray(logits)
        for k in ("k", "v", "kmean", "length"):
            out[f"new{budget}_{k}"] = np.asarray(st[k])
np.savez(OUT_PATH, answers=json.dumps(answers), **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / "jax.npz")
    code = JAX_SCRIPT.replace("SRC_PATH", repr(SRC)).replace("OUT_PATH", repr(path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    data = dict(np.load(path))
    data["answers"] = json.loads(str(data["answers"]))
    return data


def _answers(m):
    return {"axis_names": list(m.axis_names), "shape": dict(m.shape), "size": int(m.devices.size),
            "tp": list(M.tp_axes(m)), "kv": list(M.kv_axes(m)), "dp": list(M.dp_axes(m))}


# -- the meshes -----------------------------------------------------------------
@pytest.mark.parametrize("name,build", [
    ("serving0", lambda d: M.make_serving_mesh(devices=d)),
    ("serving2", lambda d: M.make_serving_mesh(kv_split=2, devices=d)),
    ("serving4", lambda d: M.make_serving_mesh(kv_split=4, devices=d)),
    ("host22", lambda d: M.make_host_mesh(2, 2, devices=d)),
    ("host14", lambda d: M.make_host_mesh(1, 4, devices=d)),
])
def test_meshes_match_jax(jax_run, name, build):
    m = build([CPU] * 4)
    assert _answers(m) == jax_run["answers"][name]
    assert m.devices.shape == tuple(m.shape[a] for a in m.axis_names)
    assert all(d == CPU for d in m.devices.reshape(-1))


def test_mesh_errors_match_jax(jax_run):
    for k in (3, -2):
        with pytest.raises(ValueError) as e:
            M.make_serving_mesh(kv_split=k, devices=[CPU] * 4)
        assert str(e.value) == jax_run["answers"][f"error{k}"]
    with pytest.raises(ValueError, match="kv_split"):
        M.make_serving_mesh(kv_split=2, devices=[CPU])
    with pytest.raises(ValueError, match="needs 256 devices, 8 given"):
        M.make_production_mesh(devices=[CPU] * 8)
    with pytest.raises(ValueError, match="needs 512 devices, 300 given"):
        M.make_production_mesh(multi_pod=True, kv_split=4, devices=[CPU] * 300)
    with pytest.raises(ValueError):
        M.make_host_mesh(2, 3, devices=[CPU] * 4)


def test_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_serving_mesh()


@pytest.mark.parametrize("multi_pod,kv_split", [(False, 0), (False, 4), (True, 0), (True, 2)])
def test_production_mesh_axes_match_jax(multi_pod, kv_split):
    """The production mesh's axes, and every axis helper on it, against the
    JAX helpers on the same axis names (they read nothing else); 256 (512)
    CPU entries, so the serving mesh over them is the production one."""
    n = 512 if multi_pod else 256
    m = M.make_production_mesh(multi_pod=multi_pod, kv_split=kv_split, devices=[CPU] * n)
    want = {(False, 0): ("data", "model"), (False, 4): ("data", "kv", "rep"),
            (True, 0): ("pod", "data", "model"), (True, 2): ("pod", "data", "kv", "rep")}
    assert m.axis_names == want[(multi_pod, kv_split)] and m.devices.size == n
    fake = types.SimpleNamespace(axis_names=m.axis_names)
    for port, ref in ((M.tp_axes, jax_mesh.tp_axes), (M.kv_axes, jax_mesh.kv_axes),
                      (M.dp_axes, jax_mesh.dp_axes)):
        assert port(m) == ref(fake)
    if not multi_pod:
        s = M.make_serving_mesh(kv_split=kv_split, devices=[CPU] * n)
        assert s.axis_names == m.axis_names and s.shape == m.shape


def test_shard_devices_order():
    """Row-major over the named axes, other axes at index 0."""
    devs = [torch.device("cpu", i) for i in range(8)]
    m = M.make_host_mesh(2, 4, devices=devs)
    assert M.shard_devices(m, ("model",)) == devs[:4]
    assert M.shard_devices(m, ("data", "model")) == devs
    assert M.shard_devices(m, ("data",)) == [devs[0], devs[4]]


# -- the sharded paged attend -------------------------------------------------------
def _paged_inputs():
    """tests/test_sharded_decode.py's inputs: 10 pages (padding past 8 shards),
    a full row over both halves of the pool and a ragged row of 3 pages and
    pad slots, partial final pages."""
    b, n_pages, page, n_kv, n_q, d = 2, 10, 4, 2, 4, 16
    n_active = 6
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, n_q, d)).astype(np.float32)
    k_pool = rng.normal(size=(b, n_pages, page, n_kv, d)).astype(np.float32)
    v_pool = rng.normal(size=(b, n_pages, page, n_kv, d)).astype(np.float32)
    table = np.full((b, n_active), -1, np.int32)
    table[0] = [7, 2, 9, 0, 4, 5]
    table[1, :3] = [1, 8, 3]
    lengths = np.array([21, 9], np.int32)
    return q, k_pool, v_pool, table, lengths


@pytest.mark.parametrize("kv_split", [0, 2])
def test_sharded_paged_decode_matches_jax_on_8_shards(kv_split):
    inputs = _paged_inputs()
    ref_out, ref_mass = (np.asarray(x) for x in jax_decode_attention(
        *(jnp.asarray(x) for x in inputs), use_kernel=False))
    mesh = M.make_serving_mesh(kv_split=kv_split, devices=[CPU] * 8)
    assert mesh.axis_names == (("kv", "rep") if kv_split else ("model",))
    out, mass = make_sharded_paged_decode(mesh)(*(torch.from_numpy(x) for x in inputs))
    assert out.dtype == torch.float32 and mass.shape == ref_mass.shape
    assert np.abs(out.numpy() - ref_out).max() < 1e-5
    assert np.abs(mass.numpy() - ref_mass).max() < 1e-5
    assert np.abs(mass.numpy()[1, :, 3:]).max() == 0.0  # pad slots: exactly no mass
    np.testing.assert_allclose(mass.numpy().sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_on_another_device_attends_over_a_copy(n_shards):
    """Shards whose device is not the pool's (``cpu:i`` is not ``cpu``) copy
    their pages, the last shard's zero-padded, with the table rebased: the
    same results as the shards that read the pool in place."""
    inputs = [torch.from_numpy(x) for x in _paged_inputs()]
    same = make_sharded_paged_decode(M.make_serving_mesh(devices=[CPU] * n_shards))(*inputs)
    other = M.make_serving_mesh(devices=[torch.device("cpu", i) for i in range(n_shards)])
    moved = make_sharded_paged_decode(other)(*inputs)
    for a, b in zip(same, moved):
        assert a.device == CPU and torch.equal(a, b)


@pytest.mark.parametrize("b,n,n_shards", [(3, 69, 8), (1, 7, 2), (2, 5, 3)])
def test_shard_tables_are_aligned_and_partition_the_slots(b, n, n_shards):
    """Each shard's table (the kernel takes 16-byte aligned tables) keeps
    exactly the slots whose page it owns and -1 elsewhere; pad slots stay -1
    on every shard."""
    from repro_torch.launch.sharded_sparse import _shard_tables

    rng = np.random.default_rng(b * n)
    n_pages = n + 4
    table = np.full((b, n), -1, np.int32)
    for i in range(b):
        table[i, : n - i] = rng.permutation(n_pages)[: n - i]
    local = -(-n_pages // n_shards)
    tables = _shard_tables(torch.from_numpy(table), local, n_shards)
    for s in range(n_shards):
        want = np.where(table // local == s, table, -1)
        assert tables[s].is_contiguous() and tables[s].data_ptr() % 16 == 0
        np.testing.assert_array_equal(tables[s].numpy(), want)
    assert ((tables >= 0).sum(0).numpy() == (table >= 0)).all()


def test_combine_ignores_shards_that_see_nothing():
    """Row 0 seen by shards 0 and 2, row 1 by shard 1 alone, row 2 by none:
    a blind shard's lse (the kernel's -inf, the plain version's ~-1e30) and
    whatever it left in out and mass (NaN here) weigh nothing, and a row no
    shard sees is 0. One shard: the partial's own bits."""
    g = torch.Generator().manual_seed(0)
    b, n_q, d, n_active = 3, 2, 8, 5
    outs = [torch.randn(b, n_q, d, generator=g) for _ in range(3)]
    masses = [torch.rand(b, n_q, n_active, generator=g) for _ in range(3)]
    lses = [torch.randn(b, n_q, generator=g) for _ in range(3)]
    blind = [(1, 0), (0, 1), (2, 1), (0, 2), (1, 2), (2, 2)]  # (shard, row)
    for s, r in blind:
        lses[s][r] = float("-inf") if s % 2 else -1e30 + 5.0
        outs[s][r] = float("nan")
        masses[s][r] = float("nan")
    out, mass = combine_partials(list(zip(outs, masses, lses)), CPU, torch.float32)
    lse = torch.stack(lses)
    for r, seen in ((0, (0, 2)), (1, (1,))):
        w = torch.softmax(lse[list(seen), r], dim=0)
        want_o = sum(w[i, :, None] * outs[s][r] for i, s in enumerate(seen))
        want_m = sum(w[i, :, None] * masses[s][r] for i, s in enumerate(seen))
        torch.testing.assert_close(out[r], want_o, rtol=0, atol=1e-6)
        torch.testing.assert_close(mass[r], want_m, rtol=0, atol=1e-6)
    assert torch.equal(out[2], torch.zeros(n_q, d)) and torch.equal(mass[2],
                                                                  torch.zeros(n_q, n_active))
    bf = outs[1].to(torch.bfloat16)
    one_o, one_m = combine_partials([(bf, masses[1], lses[1])], CPU, torch.bfloat16)
    assert torch.equal(one_o[1], bf[1]) and torch.equal(one_m[1], masses[1][1])


# -- the sharded sparse decode step --------------------------------------------------
@pytest.fixture(scope="module")
def sparse_model(jax_run):
    cfg = dataclasses.replace(jax_reduced_config("qwen3-1.7b", n_layers=2), dtype="float32")
    pcfg = dataclasses.replace(reduced_config("qwen3-1.7b", n_layers=2), dtype="float32")
    treedef = jax.tree_util.tree_structure(JT.init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree_util.tree_unflatten(
        treedef, [jax_run[f"p{i}"] for i in range(treedef.num_leaves)])
    return pcfg, bridge.params_from_numpy(params, "cpu")


def _port_state(jax_run):
    st = {k: torch.from_numpy(jax_run[f"s_{k}"].copy()) for k in ("k", "v", "kmean")}
    st["length"] = int(jax_run["s_length"])
    return st


@pytest.mark.parametrize("budget", [0.5, 1.0])
def test_sharded_sparse_step_matches_jax_on_a_2x2_mesh(jax_run, sparse_model, budget):
    pcfg, tparams = sparse_model
    mesh = M.make_host_mesh(2, 2, devices=[CPU] * 4)
    step = make_sharded_sparse_decode_step(pcfg, mesh, chunk_tokens=8, budget=budget)
    state = _port_state(jax_run)
    logits, new = step(tparams, torch.from_numpy(jax_run["token"]), state)
    assert new is state and new["length"] == int(jax_run[f"new{budget}_length"]) == 49
    want = jax_run[f"logits{budget}"]
    assert np.abs(logits.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    for k in ("k", "v", "kmean"):
        ref = jax_run[f"new{budget}_{k}"]
        np.testing.assert_allclose(new[k].numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert np.abs(new["k"].numpy()[0, :, 48]).max() > 0  # the append landed in shard 3


def test_sparse_step_shards_on_other_devices_work_on_copies(jax_run, sparse_model):
    """Shards whose device is not the state's (``cpu:i`` is not ``cpu``)
    step a copy of their slice and write it back: the same logits and state,
    bit for bit, as shards that work on the state in place."""
    pcfg, tparams = sparse_model
    tok = torch.from_numpy(jax_run["token"])
    runs = []
    for devs in ([CPU] * 4, [torch.device("cpu", i) for i in range(4)]):
        step = make_sharded_sparse_decode_step(pcfg, M.make_host_mesh(2, 2, devices=devs),
                                               chunk_tokens=8, budget=0.5)
        runs.append(step(tparams, tok, _port_state(jax_run)))
    (l0, s0), (l1, s1) = runs
    assert torch.equal(l0, l1) and s0["length"] == s1["length"]
    assert all(torch.equal(s0[k], s1[k]) for k in ("k", "v", "kmean"))


def test_sharded_sparse_step_indivisible_capacity_raises(jax_run, sparse_model):
    """S = 40 over 1 shard with 16-token chunks: the step names the
    constraint (tests/test_sharded_decode.py's check of the JAX step)."""
    pcfg, tparams = sparse_model
    mesh = M.make_serving_mesh(devices=[CPU])
    step = make_sharded_sparse_decode_step(pcfg, mesh, chunk_tokens=16, budget=0.5)
    state = _port_state(jax_run)
    state["k"] = state["k"][:, :, :40]
    with pytest.raises(ValueError, match=r"divisible by n_shards\*chunk_tokens"):
        step(tparams, torch.zeros(2, 1, dtype=torch.long), state)


def test_sharded_sparse_step_budget_above_one_clamps(jax_run, sparse_model):
    """budget 1.25 over m_local = 4 chunks selects 4, bit for bit budget 1.0."""
    pcfg, tparams = sparse_model
    mesh = M.make_serving_mesh(devices=[CPU])
    tok = torch.zeros(2, 1, dtype=torch.long)
    runs = [make_sharded_sparse_decode_step(pcfg, mesh, chunk_tokens=16, budget=bud)(
        tparams, tok, _port_state(jax_run))[0] for bud in (1.0, 1.25)]
    assert torch.equal(runs[0], runs[1]) and torch.isfinite(runs[0]).all()


# -- RealCompute over a mesh -----------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(jax_reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    pcfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, pcfg, params, tparams


def _ctx_data(cfg, b=3, page=16, n_res=(3, 1, 2), extra=6, suffix_len=10):
    """Per request: token, position and per layer (k_res, v_res, k_suf, v_suf)."""
    rng = np.random.default_rng(9)
    out = []
    for i in range(b):
        layers = []
        for _ in range(cfg.n_layers):
            res = (n_res[i], page, cfg.n_kv_heads, cfg.d_head)
            suf = (1, suffix_len + i, cfg.n_kv_heads, cfg.d_head)
            layers.append(tuple(rng.normal(size=s).astype(t) for s, t in (
                (res, np.float16), (res, np.float16), (suf, np.float32), (suf, np.float32))))
        out.append((7 * i + 1, 100 + suffix_len + i, layers))
    return out, page, extra


def _close(got, want):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("pool_cls", [DeviceTailPool, TailPool])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_decode_step_batch_over_a_mesh_matches_jax(models, n_shards, pool_cls):
    """Three ragged requests, two steps: the port's batched step through the
    sharded attend against the JAX backend's without a mesh."""
    cfg, pcfg, params, tparams = models
    be = RealCompute(pcfg, tparams, device="cpu",
                     tp_mesh=M.make_serving_mesh(devices=[CPU] * n_shards))
    jbe = JaxCompute(cfg, params)
    data, page, extra = _ctx_data(pcfg)
    ctxs = [DecodeBatchCtx(backend=be, token=tok, pos=pos, pools={
        l: pool_cls(kr, vr, (torch.from_numpy(ks), torch.from_numpy(vs)), page, extra,
                    device="cpu")
        for l, (kr, vr, ks, vs) in enumerate(layers)}) for tok, pos, layers in data]
    jctxs = [JaxCtx(backend=jbe, token=tok, pos=pos, pools={
        l: JaxDeviceTailPool(kr, vr, (ks, vs), page, extra)
        for l, (kr, vr, ks, vs) in enumerate(layers)}) for tok, pos, layers in data]
    for _ in range(2):
        for (lp, mp), (lj, mj) in zip(be.decode_step_batch(ctxs), jbe.decode_step_batch(jctxs)):
            _close(lp, lj)
            assert int(np.argmax(lp)) == int(np.argmax(np.asarray(lj)))
            for l in mj:
                assert np.abs(mp[l] - np.asarray(mj[l])).max() <= 1e-5
        for c, jc in zip(ctxs, jctxs):
            c.pos += 1
            jc.pos += 1


@pytest.mark.parametrize("n_shards", [1, 4])
def test_decode_attend_over_a_mesh_matches_jax(models, n_shards):
    """One request's attend over its device pool, three decode positions:
    h, the resident pages' mass, the logits and the greedy token against the
    JAX backend's attend without a mesh."""
    cfg, pcfg, params, tparams = models
    be = RealCompute(pcfg, tparams, device="cpu",
                     tp_mesh=M.make_serving_mesh(devices=[CPU] * n_shards))
    jbe = JaxCompute(cfg, params)
    (_, _, layers), *_ = _ctx_data(pcfg, b=1, n_res=(5,))[0]
    kr, vr, ks, vs = layers[1]
    tail = DeviceTailPool(kr, vr, (torch.from_numpy(ks), torch.from_numpy(vs)), 16, 6,
                          device="cpu")
    jtail = JaxDeviceTailPool(kr, vr, (ks, vs), 16, 6)
    rng = np.random.default_rng(11)
    for _ in range(3):
        h = rng.normal(size=(1, 1, cfg.d_model)).astype(np.float32)
        q = rng.normal(size=(1, 1, cfg.n_heads, cfg.d_head)).astype(np.float32)
        kv = rng.normal(size=(2, 1, 1, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
        tail.append(torch.from_numpy(kv[0]), torch.from_numpy(kv[1]))
        jtail.append(kv[0], kv[1])
        h_p, m_p = be.decode_attend(1, torch.from_numpy(h), torch.from_numpy(q), tail)
        h_j, m_j = jbe.decode_attend(1, jnp.asarray(h), jnp.asarray(q), jtail)
        _close(h_p, h_j)
        assert m_p.shape == (5,) and np.abs(m_p - np.asarray(m_j)).max() <= 1e-5
        l_p, l_j = be.logits(h_p), jbe.logits(h_j)
        _close(l_p, l_j)
        assert int(np.argmax(l_p)) == int(np.argmax(l_j))
