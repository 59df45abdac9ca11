"""The port's sharding rules, activation specs, abstract inputs, tensors on
a mesh and ``compressed_psum`` against the JAX package's, on the CPU.

One JAX subprocess on 4 forced host devices serves the module. Meshes the
4 devices cannot hold (the 16 x 16 production mesh, its kv_split 2 / 4
forms, the 2 x 16 x 16 multi-pod mesh) reach JAX's rules as duck-typed
meshes (``param_specs`` reads only ``mesh.shape`` and ``mesh.axis_names``),
with ``NamedSharding`` in ``repro.launch.sharding`` replaced by a holder of
its spec; the 4-device meshes (2 x 2 host, serving kv_split 2 / 4) use
JAX's own. Specs compare by ``repr`` (the port's ``P`` prints as JAX's
``PartitionSpec``). Limits:
- ``param_specs`` (fsdp on and off), ``batch_specs`` (batch 4 and 16,
  training or not) and ``serve_state_shardings`` (batch 4 and 16) equal for
  all 12 configs on every mesh above, a ``ValueError`` where JAX's
  ``NamedSharding`` raises one (a spec naming an axis the mesh lacks:
  ``batch_specs`` on a serving mesh);
- ``activation_spec`` equal to the spec JAX's ``constrain`` pins for every
  (role, shape) a reduced forward of qwen3-1.7b, mixtral-8x22b and
  falcon-mamba-7b makes under a 2 x 2 policy (the calls recorded by
  replacing ``constrain`` on both sides), and on a grid of shapes and
  policies covering its branches (a ``ValueError`` where JAX's raises one:
  ``dp`` names "data", which a serving mesh lacks);
- ``input_specs`` leaf by leaf (path, shape, dtype, spec) and
  ``model_flops_global`` equal for every config x ``SHAPES``;
- ``shard`` / ``unshard`` round trips bit for bit, no block aliasing
  another or the source, and the ``ValueError`` JAX's ``device_put``
  raises for a dim that does not divide its axes;
- ``compressed_psum`` over 4 participants against JAX's under
  ``shard_map``: float32 within 1e-6 of the largest element (measured
  ~1e-7: XLA sums the four dequantized terms in its own order), bfloat16
  within one bfloat16 ulp of the largest element; against the exact float32 sum within sum_i
  scale_i / 2 an element (each participant rounds to its int8 level).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import specs as JS
from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.launch import act_sharding as AS
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as PSPEC
from repro_torch.models import transformer as PT
from repro_torch.models.frontends import frontend_embed_spec
from repro_torch.train.compression import compressed_psum
from repro_torch.tree import tree_flatten_with_path

CPU = torch.device("cpu")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

# name: (axis names, sizes); the first three exist on 4 devices
MESHES = {
    "host22": (("data", "model"), (2, 2)),
    "serving2": (("kv", "rep"), (2, 2)),
    "serving4": (("kv", "rep"), (4, 1)),
    "prod": (("data", "model"), (16, 16)),
    "prod_kv2": (("data", "kv", "rep"), (16, 2, 8)),
    "prod_kv4": (("data", "kv", "rep"), (16, 4, 4)),
    "pods": (("pod", "data", "model"), (2, 16, 16)),
    "pods_kv2": (("pod", "data", "kv", "rep"), (2, 16, 2, 8)),
}

JAX_SCRIPT = """
import os, sys, json, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC_PATH)
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, list_configs, reduced_config
from repro.launch import act_sharding as AS
from repro.launch import mesh as M
from repro.launch import sharding as SH
from repro.launch import specs as SP
from repro.models import transformer as T
from repro.train.compression import compressed_psum

assert jax.device_count() == 4
ans = {"specs": {}, "act": {}, "grid": {}, "inputs": {}}
real = {"host22": M.make_host_mesh(2, 2), "serving2": M.make_serving_mesh(kv_split=2),
        "serving4": M.make_serving_mesh(kv_split=4)}

def walk(tree):
    return [["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p), x]
            for p, x in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P) or x is None)[0]]

def spec_of(x):
    return None if x is None else repr(x.spec if hasattr(x, "spec") else x)

def specs(fn):
    try:
        return [[k, spec_of(s)] for k, s in walk(fn())]
    except ValueError as e:
        return type(e).__name__

def rules(cfg, mesh):
    out = {}
    for fsdp in (True, False):
        out[f"param_specs fsdp={fsdp}"] = specs(lambda: SH.param_specs(cfg, mesh, fsdp=fsdp))
    for b in (4, 16):
        for training in (True, False):
            out[f"batch_specs b={b} training={training}"] = specs(
                lambda: SH.batch_specs(cfg, mesh, b, 64, training=training))
        out[f"serve_state_shardings b={b}"] = specs(
            lambda: SH.serve_state_shardings(cfg, mesh, b))
    return out

real_named = SH.NamedSharding
for name, (axes, sizes) in MESHES.items():
    if name in real:
        mesh = real[name]
        assert tuple(mesh.axis_names) == axes and tuple(mesh.shape[a] for a in axes) == sizes
        SH.NamedSharding = real_named
    else:
        mesh = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))
        SH.NamedSharding = lambda m, s: types.SimpleNamespace(spec=s)
    ans["specs"][name] = {c: rules(get_config(c), mesh) for c in list_configs()}
SH.NamedSharding = real_named

# the specs constrain pins: the recorded calls of a forward, then a grid
calls = []
orig_constrain = AS.constrain
def rec_constrain(x, role):
    calls.append([role, list(x.shape), None])
    return orig_constrain(x, role)
def rec_wsc(x, sh):
    calls[-1][2] = repr(sh.spec)
    return x
AS.constrain = rec_constrain
jax.lax.with_sharding_constraint = rec_wsc
host = real["host22"]
for arch in ("qwen3-1.7b", "mixtral-8x22b", "falcon-mamba-7b"):
    cfg = dataclasses.replace(reduced_config(arch, n_layers=2), dtype="float32")
    params = T.init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    calls.clear()
    with host, AS.activation_sharding(host):
        T.forward(params, {"tokens": jnp.asarray(toks)}, cfg)
    ans["act"][arch] = list(calls)
for name in ("host22", "serving2", "serving4"):
    for shard_batch in (True, False):
        for seq_parallel in (True, False):
            key = f"{name} {shard_batch} {seq_parallel}"
            ans["grid"][key] = []
            with AS.activation_sharding(real[name], shard_batch=shard_batch,
                                        seq_parallel=seq_parallel):
                for role, shape in GRID:
                    calls[:] = [[role, list(shape), None]]
                    try:
                        orig_constrain(jnp.zeros(shape), role)
                    except ValueError as e:  # a spec naming an axis the mesh lacks
                        calls[-1][2] = type(e).__name__
                    ans["grid"][key].append(calls[-1][2])

# abstract inputs on the 2 x 2 host mesh
for c in list_configs():
    cfg = get_config(c)
    for shape in SP.SHAPES:
        for sparse in ((False, True) if SP.SHAPES[shape].kind == "decode" and cfg.has_attention
                       else (False,)):
            tree = SP.input_specs(cfg, shape, host, sparse_summaries=sparse)
            ans["inputs"][f"{c} {shape} {sparse}"] = [
                [k, list(x.shape), str(x.dtype), spec_of(x.sharding)] for k, x in walk(tree)]

# compressed_psum over an axis of 4 under shard_map
mesh4 = jax.make_mesh((4,), ("i",))
rng = np.random.default_rng(5)
xs = rng.standard_normal((4, 48, 33)).astype(np.float32) * np.array([1, 10, 0.1, 3],
                                                                   np.float32)[:, None, None]
psum = {}
for dt in ("float32", "bfloat16"):
    x = jnp.asarray(xs).astype(dt).reshape(4 * 48, 33)
    f = jax.shard_map(lambda b: compressed_psum(b, "i"), mesh=mesh4, in_specs=P("i"),
                      out_specs=P("i"))
    psum[dt] = np.asarray(jnp.asarray(jax.jit(f)(x)).astype(jnp.float32)).reshape(4, 48, 33)
try:
    jax.device_put(np.zeros((3, 4), np.float32), NamedSharding(host, P("data", None)))
    ans["indivisible"] = None
except Exception as e:
    ans["indivisible"] = type(e).__name__
np.savez(OUT_PATH, answers=json.dumps(ans), xs=xs, psum_float32=psum["float32"],
         psum_bfloat16=psum["bfloat16"])
print("OK")
"""

# (role, shape) of the activation-spec grid: each branch of constrain
GRID = [("hidden", (4, 16, 8)), ("hidden", (4, 1, 8)), ("hidden", (4, 8)),
        ("heads", (4, 16, 1, 8)), ("heads", (4, 16, 2, 8)), ("heads", (4, 16, 3, 8)),
        ("heads", (4, 16, 4, 8)), ("heads", (4, 16, 8, 8)), ("heads", (4, 1, 1, 8)),
        ("heads", (4, 1, 3, 8)), ("heads", (4, 16, 8)), ("logits", (4, 16, 8))]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharding") / "jax.npz")
    code = (JAX_SCRIPT.replace("SRC_PATH", repr(SRC)).replace("OUT_PATH", repr(path))
            .replace("MESHES.items()", f"{MESHES!r}.items()").replace("GRID", repr(GRID)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(path) as data:
        out = {k: data[k] for k in data.files}
    out["answers"] = json.loads(str(out["answers"]))
    return out


def _port_mesh(name):
    axes, sizes = MESHES[name]
    devs = [CPU] * int(np.prod(sizes))
    return {
        "host22": lambda: M.make_host_mesh(2, 2, devices=devs),
        "serving2": lambda: M.make_serving_mesh(kv_split=2, devices=devs),
        "serving4": lambda: M.make_serving_mesh(kv_split=4, devices=devs),
        "prod": lambda: M.make_production_mesh(devices=devs),
        "prod_kv2": lambda: M.make_production_mesh(kv_split=2, devices=devs),
        "prod_kv4": lambda: M.make_production_mesh(kv_split=4, devices=devs),
        "pods": lambda: M.make_production_mesh(multi_pod=True, devices=devs),
        "pods_kv2": lambda: M.make_production_mesh(multi_pod=True, kv_split=2, devices=devs),
    }[name]()


def _walk(tree):
    return [[("/".join(str(k) for k in p)), x] for p, x in tree_flatten_with_path(tree)]


def _spec_of(x):
    return None if x is None else repr(x.spec if isinstance(x, SH.NamedSharding) else x)


def _specs(fn):
    """[path, spec] of each leaf fn() gives, or the name of the ValueError
    it raises (JAX's ``NamedSharding`` refuses an axis its mesh lacks)."""
    try:
        return [[k, _spec_of(s)] for k, s in _walk(fn())]
    except ValueError as e:
        return type(e).__name__


def _rules(cfg, mesh):
    out = {}
    for fsdp in (True, False):
        out[f"param_specs fsdp={fsdp}"] = _specs(lambda: SH.param_specs(cfg, mesh, fsdp=fsdp))
    for b in (4, 16):
        for training in (True, False):
            out[f"batch_specs b={b} training={training}"] = _specs(
                lambda: SH.batch_specs(cfg, mesh, b, 64, training=training))
        out[f"serve_state_shardings b={b}"] = _specs(
            lambda: SH.serve_state_shardings(cfg, mesh, b))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_match_jax(jax_run, mesh_name):
    mesh = _port_mesh(mesh_name)
    assert (tuple(mesh.axis_names), tuple(mesh.shape[a] for a in mesh.axis_names)) == \
        MESHES[mesh_name]
    want = jax_run["answers"]["specs"][mesh_name]
    assert sorted(want) == list_configs()
    for name in list_configs():
        assert _rules(get_config(name), mesh) == want[name], name


def test_param_shardings_tree():
    cfg = get_config("qwen3-1.7b")
    mesh = _port_mesh("host22")
    sh = SH.param_shardings(cfg, mesh)
    specs = SH.param_specs(cfg, mesh)
    for (p, s), (q, spec) in zip(tree_flatten_with_path(sh), tree_flatten_with_path(specs)):
        assert p == q and isinstance(s, SH.NamedSharding) and s.mesh is mesh and s.spec == spec
    assert SH.opt_state_shardings(sh) == {"m": sh, "v": sh, "step": None}
    assert SH.P(("data",), None) == ("data", None) and SH.P((), "x") == (None, "x")
    assert repr(SH.P(("pod", "data"), None)) == "PartitionSpec(('pod', 'data'), None)"


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x22b", "falcon-mamba-7b"])
def test_activation_specs_of_a_forward(jax_run, arch, monkeypatch):
    """Every (role, shape) the port's forward constrains, with the spec
    ``activation_spec`` gives it, against JAX's forward's pinned specs
    (JAX traces its layer scan once, the port calls each layer: the
    distinct calls compare); the port's ``constrain`` returns its input."""
    import dataclasses

    cfg = dataclasses.replace(reduced_config(arch, n_layers=2), dtype="float32")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    mesh = _port_mesh("host22")
    calls = []
    real = AS.constrain

    def recording(x, role):
        calls.append((role, tuple(x.shape),
                      repr(AS.activation_spec(tuple(x.shape), role, AS.current_policy()))))
        y = real(x, role)
        assert y is x
        return y

    monkeypatch.setattr(AS, "constrain", recording)
    with AS.activation_sharding(mesh):
        PT.forward(params, {"tokens": torch.as_tensor(toks)}, cfg)
    assert AS.current_policy() is None
    want = {(r, tuple(s), spec) for r, s, spec in jax_run["answers"]["act"][arch]}
    assert set(calls) == want
    per_layer = 3 * cfg.has_attention + (cfg.family != "ssm")
    assert len(calls) == cfg.n_layers * per_layer


@pytest.mark.parametrize("mesh_name", ["host22", "serving2", "serving4"])
def test_activation_spec_grid(jax_run, mesh_name):
    mesh = _port_mesh(mesh_name)
    for shard_batch in (True, False):
        for seq_parallel in (True, False):
            want = jax_run["answers"]["grid"][f"{mesh_name} {shard_batch} {seq_parallel}"]
            with AS.activation_sharding(mesh, shard_batch=shard_batch,
                                        seq_parallel=seq_parallel):
                pol = AS.current_policy()
                got = []
                for role, shape in GRID:
                    try:
                        spec = AS.activation_spec(shape, role, pol)
                        got.append(None if spec is None else repr(spec))
                    except ValueError as e:
                        got.append(type(e).__name__)
            assert got == want
    assert AS.activation_spec((4, 16, 8), "hidden", None) is None


@pytest.mark.parametrize("name", list_configs())
def test_input_specs_and_flops_match_jax(jax_run, name):
    cfg = get_config(name)
    mesh = _port_mesh("host22")
    for shape, spec in PSPEC.SHAPES.items():
        assert spec == PSPEC.ShapeSpec(**{k: getattr(JS.SHAPES[shape], k) for k in
                                          ("name", "kind", "seq", "batch", "grad_accum")})
        assert PSPEC.model_flops_global(cfg, shape) == JS.model_flops_global(
            jax_get_config(name), shape)
        for sparse in ((False, True) if spec.kind == "decode" and cfg.has_attention
                       else (False,)):
            tree = PSPEC.input_specs(cfg, shape, mesh, sparse_summaries=sparse)
            got = [[k, list(x.shape), str(x.dtype).removeprefix("torch."),
                    _spec_of(x.sharding)] for k, x in _walk(tree)]
            assert got == jax_run["answers"]["inputs"][f"{name} {shape} {sparse}"]
    e = frontend_embed_spec(cfg, 2, 8)
    assert e.shape == (2, 8, cfg.d_model) and e.dtype == cfg.activation_dtype()


# -- tensors on a mesh -----------------------------------------------------------
def _storage(t):
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("spec", [(), (None, None), ("data", None), ("model", "data"),
                                  (("data", "model"), None), (None, ("model", "data"))])
def test_shard_round_trip_and_no_aliasing(spec):
    mesh = _port_mesh("host22")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 12)).astype(np.float32))
    sh = SH.NamedSharding(mesh, SH.P(*spec))
    st = SH.shard(x, sh)
    assert st.shape == (8, 12) and st.dtype == torch.float32 and st.blocks.shape == (2, 2)
    assert torch.equal(SH.unshard(st, CPU), x)
    ptrs = [_storage(b) for b in st.blocks.reshape(-1)]
    assert len(set(ptrs)) == 4 and _storage(x) not in ptrs
    before = x.clone()
    for b in st.blocks.reshape(-1):
        b.add_(1.0)  # a block written in place moves neither the source nor another block
    assert torch.equal(x, before)
    parts = {tuple((s.start, s.stop) for s in SH.block_index(x.shape, sh, pos))
             for pos in st.positions()}
    named = [a for e in spec if e for a in ((e,) if isinstance(e, str) else e)]
    assert len(parts) == 2 ** len(named)  # a distinct block per position of its axes


def test_shard_tree_keeps_none_and_bfloat16():
    mesh = _port_mesh("host22")
    tree = {"a": torch.arange(8, dtype=torch.float32).to(torch.bfloat16).reshape(4, 2),
            "b": [np.arange(6, dtype=np.int32), torch.zeros(())],
            "c": torch.ones(3), "d": None}
    sh = {"a": SH.NamedSharding(mesh, SH.P("data", "model")),
          "b": [SH.NamedSharding(mesh, SH.P("model")), SH.NamedSharding(mesh, SH.P())],
          "c": None, "d": None}
    st = SH.shard_tree(tree, sh)
    assert st["c"] is tree["c"] and st["d"] is None
    back = SH.unshard_tree(st, CPU)
    assert torch.equal(back["a"], tree["a"]) and back["a"].dtype == torch.bfloat16
    assert torch.equal(back["b"][0], torch.arange(6, dtype=torch.int32))
    assert back["b"][1].shape == () and torch.equal(back["c"], tree["c"]) and back["d"] is None


def test_indivisible_dim_raises_as_jax(jax_run):
    assert jax_run["answers"]["indivisible"] == "ValueError"
    mesh = _port_mesh("host22")
    with pytest.raises(ValueError, match="divisible by 2"):
        SH.shard(np.zeros((3, 4), np.float32), SH.NamedSharding(mesh, SH.P("data", None)))


# -- compressed_psum --------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_matches_jax(jax_run, dtype):
    xs = jax_run["xs"]
    tdtype = getattr(torch, dtype)
    parts = [torch.from_numpy(x).to(tdtype) for x in xs]
    got = compressed_psum(parts)
    want = jax_run[f"psum_{dtype}"]
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == tdtype and g.shape == parts[0].shape
        g = g.to(torch.float32).numpy()
        # float32: the four terms summed in another order, or fused, by XLA;
        # bfloat16: that, then one rounding to bfloat16
        tol = 1e-6 if dtype == "float32" else 2.0 ** -7
        assert np.abs(g - w).max() <= tol * np.abs(w).max()
    exact = sum(p.to(torch.float32) for p in parts)
    scales = sum(float(p.to(torch.float32).abs().max()) / 127.0 for p in parts)
    if dtype == "float32":
        assert float((got[0] - exact).abs().max()) <= scales / 2 * (1 + 1e-5)
    assert all(torch.equal(got[0], g) for g in got[1:])
