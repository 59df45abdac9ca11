"""The port's dry run (``launch/dryrun.py``) against the JAX package's, on
the CPU.

- Per-device argument bytes: the port's ``arg_bytes`` (each input leaf's
  block from the shard layout) equals, to the byte, the sum of each JAX
  ``input_specs`` leaf's ``sharding.shard_shape``, for every assigned config
  and shape on both production meshes and on the GQA mesh (kv_split 4),
  and for every decode shape again with the sparse decode's chunk
  summaries (``sparse_summaries=True``). JAX's side runs in one subprocess
  with 512 forced host devices and compiles nothing.
- Products: a reduced float32 decode step's FLOPs counted by
  ``StepAnalyzer`` on meta tensors are within 1 % of ``HloAnalyzer`` on
  JAX's compiled step on one host device (the two count the same dots;
  1 % leaves room for a dot XLA folds or a product one side runs as
  elementwise work).
- ``run_cell`` on four full-width cells (dense train, an ``ssm`` config, an
  MoE config, ``--sharded-sparse``) writes rows with the JAX rows' keys
  under the JAX file names; ``--ssm-bf16`` is refused.
- The sparse decode's cell over the mesh (qwen3-1.7b decode_32k,
  ``--sparse --cached-summaries``) is counted per position: it fits, holds
  the dense row's bytes plus its chunk summaries' blocks and temporaries,
  and its FLOPs a device times 256 are within 1.15x of the whole unsharded
  sparse step's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED, get_config, reduced_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, input_specs

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
META = torch.device("meta")
MESHES = {"single": dict(), "multi": dict(multi_pod=True), "single~kv4": dict(kv_split=4)}
KV_SPLIT_ARCH = "qwen3-1.7b"

JAX_ARG_BYTES = """
import os, sys, json, math
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
sys.path.insert(0, SRC_PATH)
import jax
from repro.configs import ASSIGNED, get_config
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh
from repro.launch.sharding import param_shardings
from repro.models import transformer as T

shapes = {}


def param_specs_tree(cfg, mesh, *, fsdp=True):  # one eval_shape a config
    if cfg.name not in shapes:
        shapes[cfg.name] = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
    return S._with_shardings(shapes[cfg.name], param_shardings(cfg, mesh, fsdp=fsdp))


S.param_specs_tree = param_specs_tree
meshes = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True),
          "single~kv4": make_production_mesh(kv_split=4)}
out = {}
for arch in ASSIGNED:
    cfg = get_config(arch)
    for shape in S.SHAPES:
        for mk, mesh in meshes.items():
            if mk == "single~kv4" and arch != KV_SPLIT_ARCH:
                continue
            for sparse in (False, True) if S.SHAPES[shape].kind == "decode" else (False,):
                args = S.input_specs(cfg, shape, mesh, sparse_summaries=sparse)
                out[f"{arch}|{shape}|{mk}" + ("|sparse" if sparse else "")] = sum(
                    math.prod(x.sharding.shard_shape(x.shape)) * x.dtype.itemsize
                    for x in jax.tree_util.tree_leaves(args))
print(json.dumps(out))
"""


def test_per_device_argument_bytes_equal_jax():
    code = JAX_ARG_BYTES.replace("SRC_PATH", repr(SRC)).replace("KV_SPLIT_ARCH",
                                                                 repr(KV_SPLIT_ARCH))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    meshes = {k: make_production_mesh(devices=[META] * (512 if "multi_pod" in kw else 256), **kw)
              for k, kw in MESHES.items()}
    n_decode = sum(1 for s in SHAPES.values() if s.kind == "decode")
    assert len(want) == (len(ASSIGNED) * 2 + 1) * (len(SHAPES) + n_decode)
    got = {}
    for key in want:
        arch, shape, mk, *sparse = key.split("|")
        specs = input_specs(get_config(arch), shape, meshes[mk], sparse_summaries=bool(sparse))
        got[key] = DR.arg_bytes(specs, meshes[mk])
    assert got == want


def test_decode_step_products_match_hlo_analyzer():
    """A reduced float32 qwen3 decode step (b 2 over a 64-position cache):
    the port's counted products on meta tensors within 1 % of JAX's
    compiled step's dot FLOPs (``HloAnalyzer``, the layer scan's trip count
    applied)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as jax_reduced_config
    from repro.launch.roofline import HloAnalyzer
    from repro.launch.steps import make_decode_step as jax_decode_step
    from repro.models import transformer as JT
    from repro_torch.launch.steps import make_decode_step

    cfg = dataclasses.replace(reduced_config("qwen3-1.7b", n_layers=2), dtype="float32")
    jcfg = dataclasses.replace(jax_reduced_config("qwen3-1.7b", n_layers=2), dtype="float32")
    b, max_len = 2, 64
    params = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    state = jax.eval_shape(lambda: JT.init_serve_state(jcfg, b, max_len))
    token = jax.ShapeDtypeStruct((b, 1), jnp.int32)
    text = jax.jit(jax_decode_step(jcfg)).lower(params, token, state).compile().as_text()
    want = HloAnalyzer(text).entry_metrics().flops

    def meta(x):
        return torch.empty(x.shape, dtype=getattr(torch, str(x.dtype)), device=META)

    t_params = jax.tree_util.tree_map(meta, params)
    t_state = {k: (max_len - 1 if k == "length" else meta(v)) for k, v in state.items()}
    with RL.StepAnalyzer() as a:
        make_decode_step(cfg)(t_params, torch.empty((b, 1), dtype=torch.int32, device=META),
                              t_state)
    assert want > 0
    assert a.metrics.flops == pytest.approx(want, rel=0.01)


CELLS = [
    dict(arch="qwen3-1.7b", shape_name="train_4k", mesh_kind="single"),
    dict(arch="falcon-mamba-7b", shape_name="prefill_32k", mesh_kind="single"),
    dict(arch="granite-moe-3b-a800m", shape_name="decode_32k", mesh_kind="multi"),
    dict(arch="qwen3-1.7b", shape_name="decode_32k", mesh_kind="single", sharded_sparse=True),
]


def test_run_cell_writes_jax_rows(tmp_path):
    """Each cell's row carries every key of a JAX row, under the JAX file
    name, with finite roofline terms; the train cell counts its flash
    launches and the sampled parts' work, the ssm cell the scan's, the
    sharded sparse cell its combines' all-reduces."""
    from repro.launch.roofline import RooflineReport

    jax_keys = {f.name for f in dataclasses.fields(RooflineReport)} | {
        "ok", "compile_s", "devices", "arg_bytes", "temp_bytes", "out_bytes", "alias_bytes",
        "cost_flops", "cost_bytes"}
    for cell in CELLS:
        row = DR.run_cell(**cell, out_dir=str(tmp_path))
        variant = "~shsparse" if cell.get("sharded_sparse") else ""
        name = f"{cell['arch']}_{cell['shape_name']}{variant}_{cell['mesh_kind']}.json"
        with open(tmp_path / name) as f:
            written = json.load(f)
        assert jax_keys <= set(written), jax_keys - set(written)
        assert row["ok"] and written["devices"] == (512 if cell["mesh_kind"] == "multi" else 256)
        for k in ("flops", "hbm_bytes", "t_compute", "t_memory", "bytes_per_device"):
            assert np.isfinite(row[k]) and row[k] > 0, (name, k)
        # every step runs over the mesh and moves bytes between devices
        assert row["t_collective"] > 0, name
        assert row["bytes_per_device"] == (row["arg_bytes"] + row["temp_bytes"]
                                           + row["out_bytes"] - row["alias_bytes"])
        assert row["fits"] == (row["bytes_per_device"] <= 80e9)
        launches = row["launches"]
        if cell["shape_name"] == "train_4k":
            # one dp part of one microbatch run, its first tensor shard, remat:
            # 2 x 28 forwards, 28 backwards; the row-parallel sums' all-reduces
            assert launches == {"flash_attention/wgmma": 56, "flash_attention_bwd/wgmma": 28}
            assert set(row["coll_bytes"]) == {"all-gather", "all-reduce", "reduce-scatter"}
        elif cell["arch"] == "falcon-mamba-7b":
            # the first tensor shard of the first dp shard, a launch a layer
            assert launches == {"selective_scan/chunked": 64}
            assert set(row["coll_bytes"]) == {"all-gather", "all-reduce"}
        elif cell.get("sharded_sparse"):
            # each shard's slice gathered where the state's blocks lie, the combine
            assert set(row["coll_bytes"]) == {"all-gather", "all-reduce"} and not launches
            assert "one-device" not in row["note"]
        else:  # granite's decode over the mesh: 40 experts, each one's d_ff split 16 ways
            assert set(row["coll_bytes"]) == {"all-gather", "all-reduce", "collective-permute"}
    assert len(os.listdir(tmp_path)) == len(CELLS)


def test_ssm_bf16_is_refused(tmp_path, monkeypatch, capsys):
    with pytest.raises(ValueError, match="bfloat16"):
        DR.run_cell("falcon-mamba-7b", "decode_32k", "single", ssm_bf16=True)
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "falcon-mamba-7b", "--ssm-bf16",
                                      "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        DR.main()
    assert e.value.code == 2 and "bfloat16 scan is not ported" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_prefill_cell_over_the_mesh_fits():
    """qwen3-1.7b prefill_32k on the 16 x 16 mesh through the mesh step
    (``make_prefill_step(cfg, mesh=)``): it fits 80 GB a device, a flash
    launch a layer is counted for the first position, and its FLOPs a
    device times 256 are within 1.15x of the whole step's count without a
    mesh (no position repeats another's products beyond the kv heads two
    shards read)."""
    from repro_torch.launch.steps import make_prefill_step

    row = DR.run_cell("qwen3-1.7b", "prefill_32k", "single")
    assert row["fits"] and row["bytes_per_device"] < 80e9
    assert row["launches"] == {"flash_attention/wgmma": 28}
    assert {"all-gather", "all-reduce", "collective-permute"} <= set(row["coll_bytes"])
    cfg = get_config("qwen3-1.7b")
    mesh = make_production_mesh(devices=[META] * 256)
    args = DR.materialize(cfg, "prefill_32k", input_specs(cfg, "prefill_32k", mesh), mesh,
                          one_device=True)
    with RL.StepAnalyzer() as whole:
        make_prefill_step(cfg)(*args)
    ratio = row["flops"] * 256 / whole.metrics.flops
    assert 1.0 <= ratio <= 1.15, ratio


def test_sparse_decode_cell_over_the_mesh_fits():
    """qwen3-1.7b decode_32k ``--sparse --cached-summaries`` on the 16 x 16
    mesh through ``make_sparse_decode_step(cfg, mesh=)``: counted per
    position (no one-device note), it fits 80 GB a device, its arguments are
    the dense row's plus its chunk summaries' blocks, its bytes a device at
    most the dense row's plus those blocks and its temporaries, it declares
    the chunk scores' all-reduce, and its FLOPs a device times 256 are
    within 1.0-1.15x of the whole unsharded sparse step's count (each block
    attends over the picks it holds, an even share of them on meta)."""
    from repro_torch.launch.steps import make_sparse_decode_step

    dense = DR.run_cell("qwen3-1.7b", "decode_32k", "single")
    row = DR.run_cell("qwen3-1.7b", "decode_32k", "single", sparse=True, cached_summaries=True)
    assert row["ok"] and row["fits"] and row["bytes_per_device"] < 80e9
    assert "one-device" not in row["note"] and not row["launches"]
    cfg = get_config("qwen3-1.7b")
    mesh = make_production_mesh(devices=[META] * 256)
    specs = input_specs(cfg, "decode_32k", mesh, sparse_summaries=True)
    kmean = DR.arg_bytes({"kmean": specs[2]["kmean"]}, mesh)
    assert kmean > 0 and row["arg_bytes"] == dense["arg_bytes"] + kmean
    assert row["bytes_per_device"] <= dense["bytes_per_device"] + kmean + row["temp_bytes"]
    assert {"all-gather", "all-reduce", "collective-permute"} <= set(row["coll_bytes"])
    args = DR.materialize(cfg, "decode_32k", specs, mesh, one_device=True)
    with RL.StepAnalyzer() as whole:
        make_sparse_decode_step(cfg, chunk_tokens=16, budget=0.05, cached_summaries=True)(*args)
    ratio = row["flops"] * 256 / whole.metrics.flops
    assert 1.0 <= ratio <= 1.15, ratio
