"""Multi-pod dry run of the port: every (arch x shape x mesh) cell counted on
meta tensors, without a card.

  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch

The JAX package's dry run (``src/repro/launch/dryrun.py``) lowers and
compiles each cell on 512 forced host devices and reads XLA's memory and
cost analyses and the HLO's roofline terms. The port has no compiler, so a
cell builds the production mesh over meta devices, materializes the leaves
of ``input_specs`` on ``device="meta"`` at the shapes the port computes
with, runs the step under ``roofline.StepAnalyzer`` inside
``activation_sharding(...)``, and writes a row with the JAX rows' keys and
file names:

- the roofline terms (``roofline.roofline``) of one device's metrics,
  priced at the H100's published peaks; ``cost_flops`` and ``cost_bytes``
  are the analyzer's totals over the whole step (every device's work, as
  the process runs it), where JAX's are XLA's ``cost_analysis()``;
- ``compile_s`` is the count's seconds;
- ``bytes_per_device`` by the reference's formula, arguments +
  temporaries + outputs - donated aliases, counted from the layout and the
  port's design, not from an allocator: every meta device is one device,
  so the meta tensors' totals are not a device's.

  - Arguments: each input leaf's block on one device
    (``sharding.block_index``).
  - Temporaries, for the train step over the mesh (``launch/steps.py``):
    the float32 gradient accumulators of one position's blocks, and the
    peak live bytes of one data-parallel part's forward and backward (the
    analyzer's largest loop item), which under the analyzer's sampling of
    the tensor shards are those of the first position: its rows' saved
    activations, one layer's gathered slice and compute, its vocabulary
    columns' logits. For the serving steps over the mesh
    (``launch/tp_compute.py``), one position's: the step's own peak live
    bytes, sampled the same way (its rows' activations, its gathered layer
    and its largest loop item at once), less the logits.
  - Outputs and aliases: the train step returns new params and moments
    (AdamW updates nothing in place), so one position's blocks are outputs
    and nothing aliases; a serving step updates its state in place, so
    the state's blocks are outputs that alias their arguments, and the
    logits (whole, on the mesh's first device) are new.

  ``fits`` says whether that is within one card's memory; a cell that
  does not fit is reported, not cut. The mesh steps gather one layer's
  slice at a time. The sparse decode rows (``--sparse``, with or without
  ``--cached-summaries``) run ``make_sparse_decode_step(mesh=)``, whose
  blocks each attend over the picked chunks they hold: on meta tensors,
  which hold no picks, each block is taken to hold an even share of them;
  the ``--sharded-sparse`` rows run ``make_sharded_sparse_decode_step`` on
  the same laid-out inputs, the first shard's device computing the
  projections on one layer's gathered weights.

A cell's repeated loops (the mesh steps' parts, tensor shards and cache
blocks, and AdamW's positions) are counted by sampling (``roofline.loop``).
``--ssm-bf16`` is refused, before
any count, as ``models/ssm.py``'s ``mamba_block`` refuses it; ``--ssm-chunk``
is applied and tagged, and changes nothing the CUDA scan does (its chunk is
256); ``--seq-parallel`` is tagged, and the port's ``constrain`` returns its
input (``launch/act_sharding.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.kernels.selective_scan.ops import CHUNK as SCAN_CHUNK
from repro_torch.launch import roofline as RL
from repro_torch.launch.act_sharding import activation_sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import ShardedTensor, block_index
from repro_torch.launch.specs import SHAPES, ShapeDtypeStruct, input_specs, model_flops_global
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_sparse_decode_step,
    make_train_step,
)
from repro_torch.models.ssm import check_scan_dtype
from repro_torch.tree import tree_leaves, tree_map

META = torch.device("meta")

_REMAT = {"nothing": True, "dots": "dots", False: False, True: True}


def build_step(cfg, shape_name: str, *, sparse: bool = False,
               cached_summaries: bool = False, sharded_sparse: bool = False,
               mesh=None,
               grad_accum: Optional[int] = None, remat="nothing",
               block_q: int = 512):
    """(step, donated argument numbers) for the cell, as the reference picks
    them: the train step over ``mesh``, prefill, or decode (dense, sparse
    or sharded sparse). ``remat`` "nothing" saves nothing inside a layer
    (the port's ``remat=True``), "dots" its products, False none."""
    spec = SHAPES[shape_name]
    if spec.kind == "train":
        ga = grad_accum if grad_accum is not None else spec.grad_accum
        fn = make_train_step(cfg, grad_accum=ga, remat=_REMAT[remat], block_q=block_q, mesh=mesh)
        donate = (0, 1)
    elif spec.kind == "prefill":
        fn = make_prefill_step(cfg, block_q=block_q, mesh=mesh)
        donate = (2,)
    else:
        if sharded_sparse and cfg.has_attention:
            from repro_torch.launch.sharded_sparse import make_sharded_sparse_decode_step
            fn = make_sharded_sparse_decode_step(cfg, mesh, chunk_tokens=16, budget=0.05)
        elif sparse and cfg.has_attention:
            fn = make_sparse_decode_step(cfg, chunk_tokens=16, budget=0.05,
                                         cached_summaries=cached_summaries, mesh=mesh)
        else:
            fn = make_decode_step(cfg, mesh=mesh)
        donate = (2,)
    return fn, donate


def _block_shape(x: ShapeDtypeStruct, mesh):
    pos = (0,) * mesh.devices.ndim
    return tuple(sl.stop - sl.start for sl in block_index(x.shape, x.sharding, pos))


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def arg_bytes(args, mesh) -> int:
    """Bytes of the input leaves' blocks on one device of ``mesh``."""
    return sum(_bytes(_block_shape(x, mesh), x.dtype) for x in tree_leaves(args))


def _sharded(x: ShapeDtypeStruct, mesh) -> ShardedTensor:
    """A leaf laid out on ``mesh`` with a meta block at each position."""
    shape = _block_shape(x, mesh)
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(*mesh.devices.shape):
        blocks[pos] = torch.empty(shape, dtype=x.dtype, device=META)
    return ShardedTensor(tuple(x.shape), x.dtype, x.sharding, blocks)


def materialize(cfg, shape_name: str, args, mesh, *, one_device: bool = False):
    """The step's arguments on meta, at the shapes the port computes with:
    the train step's params and moments laid out on the mesh (a meta block
    at each position) and its batch whole; a serving step's params, inputs
    and state laid out on the mesh too, or whole where ``one_device`` (to
    count a whole step without a mesh), the state's ``length`` a Python int
    (prefill 0; decode at the last position of its cache)."""
    spec = SHAPES[shape_name]

    def whole(x):
        return torch.empty(x.shape, dtype=x.dtype, device=META)

    def laid(x):
        return _sharded(x, mesh)

    if spec.kind == "train":
        params, opt, batch = args
        return tree_map(laid, params), tree_map(laid, opt), tree_map(whole, batch)
    params, inputs, state = args
    put = whole if one_device else laid
    state = {k: (0 if spec.kind == "prefill" else spec.seq - 1) if k == "length" else put(x)
             for k, x in state.items()}
    return tree_map(put, params), tree_map(put, inputs), state


def _variant(*, sharded_sparse, sparse, cached_summaries, fsdp, remat, ssm_chunk, ssm_bf16,
             moe_cf, grad_accum, kv_split, seq_parallel) -> str:
    variant = ""
    if sharded_sparse:
        variant += "~shsparse"
    if sparse:
        variant += "~sparse"
    if cached_summaries:
        variant += "~csum"
    if not fsdp:
        variant += "~nofsdp"
    if remat == "dots":
        variant += "~dots"
    if ssm_chunk:
        variant += f"~ssmc{ssm_chunk}"
    if ssm_bf16:
        variant += "~ssmbf16"
    if moe_cf:
        variant += f"~cf{moe_cf}"
    if grad_accum is not None:
        variant += f"~ga{grad_accum}"
    if kv_split:
        variant += f"~kv{kv_split}"
    if seq_parallel:
        variant += "~sp"
    return variant


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             sparse: bool = False, cached_summaries: bool = False,
             sharded_sparse: bool = False,
             grad_accum: Optional[int] = None,
             remat="nothing", fsdp: bool = True, kv_split: int = 0,
             seq_parallel: bool = False,
             ssm_chunk: Optional[int] = None, ssm_bf16: bool = False,
             moe_cf: Optional[float] = None,
             out_dir: Optional[str] = None,
             hw: RL.Hardware = RL.Hardware()) -> Dict[str, Any]:
    """Count one cell (see the module docstring) and return its row; write
    it to ``out_dir`` under the reference's file name if given."""
    cfg = get_config(arch)
    overrides = {}
    if ssm_chunk:
        overrides["ssm_chunk"] = ssm_chunk
    if ssm_bf16:
        overrides["ssm_scan_dtype"] = "bfloat16"
    if moe_cf:
        overrides["moe_capacity_factor"] = moe_cf
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    check_scan_dtype(cfg)
    n = 512 if mesh_kind == "multi" else 256
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), kv_split=kv_split,
                                devices=[META] * n)
    n_dev = mesh.devices.size
    spec = SHAPES[shape_name]
    t0 = time.time()
    fn, _ = build_step(cfg, shape_name, sparse=sparse, cached_summaries=cached_summaries,
                       sharded_sparse=sharded_sparse, mesh=mesh, grad_accum=grad_accum,
                       remat=remat)
    specs = input_specs(cfg, shape_name, mesh, fsdp=fsdp,
                        sparse_summaries=(sparse and cached_summaries) or sharded_sparse)
    args = materialize(cfg, shape_name, specs, mesh)
    with activation_sharding(mesh, shard_batch=spec.batch >= 16,
                             seq_parallel=seq_parallel), RL.StepAnalyzer() as analyzer:
        out = fn(*args)
    t_count = time.time() - t0

    metrics = analyzer.metrics
    mf_dev = model_flops_global(cfg, shape_name) / n_dev
    a_bytes = arg_bytes(specs, mesh)
    if spec.kind == "train":
        acc = sum(4 * math.prod(_block_shape(x, mesh)) for x in tree_leaves(specs[0]))
        temp = acc + analyzer.item_peak_bytes
        out_b = arg_bytes(specs[:2], mesh) + 4  # a position's new params and moments, the loss
        alias = 0
    else:
        logits = sum(t.numel() * t.element_size() for t in tree_leaves(out[0]))
        temp = max(0, analyzer.peak_bytes - logits)
        state = arg_bytes(specs[2], mesh)
        out_b, alias = logits + state, state
    bytes_dev = float(a_bytes + temp + out_b - alias)
    variant = _variant(sharded_sparse=sharded_sparse, sparse=sparse,
                       cached_summaries=cached_summaries, fsdp=fsdp, remat=remat,
                       ssm_chunk=ssm_chunk, ssm_bf16=ssm_bf16, moe_cf=moe_cf,
                       grad_accum=grad_accum, kv_split=kv_split, seq_parallel=seq_parallel)
    report = RL.roofline(
        metrics, arch=arch, shape=shape_name + variant,
        mesh=mesh_kind, model_flops_per_device=mf_dev,
        bytes_per_device=bytes_dev, hw=hw,
        note=f"count={t_count:.1f}s devices={n_dev}")
    row = report.to_dict()
    row.update(
        ok=True,
        compile_s=t_count,
        devices=n_dev,
        arg_bytes=int(a_bytes),
        temp_bytes=int(temp),
        out_bytes=int(out_b),
        alias_bytes=int(alias),
        cost_flops=float(analyzer.whole.flops),
        cost_bytes=float(analyzer.whole.hbm_bytes),
        fits=bytes_dev <= hw.hbm_per_chip,
        aten_flops=analyzer.aten_flops,
        kernels=analyzer.kernels,
        launches={f"{k}/{v}": n for (k, v), n in analyzer.launches.items()},
    )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}{variant}_{mesh_kind}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(row, f, indent=1)
    return row


def fmt_row(r: Dict[str, Any]) -> str:
    if not r.get("ok"):
        return f"{r['arch']:22s} {r['shape']:14s} {r['mesh']:6s} FAILED: {r['error'][:90]}"
    return (f"{r['arch']:22s} {r['shape']:14s} {r['mesh']:6s} "
            f"fl/dev={r['flops']:.3e} hbm={r['hbm_bytes']:.3e} "
            f"coll={sum(r['coll_bytes'].values()):.3e} "
            f"tc={r['t_compute']*1e3:.2f}ms tm={r['t_memory']*1e3:.2f}ms "
            f"tx={r['t_collective']*1e3:.2f}ms dom={r['dominant']:10s} "
            f"useful={r['useful_ratio']:.2f} mem/dev={r['bytes_per_device']/1e9:.2f}GB "
            f"[{r['note']}]")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    p.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--sparse", action="store_true",
                   help="count the ContiguousKV sparse decode for decode shapes")
    p.add_argument("--cached-summaries", action="store_true",
                   help="sparse decode with resident chunk-mean summaries")
    p.add_argument("--sharded-sparse", action="store_true",
                   help="per-shard top-k sparse decode over the mesh")
    p.add_argument("--no-fsdp", action="store_true",
                   help="replicate weights over data (drop ZeRO-3 gathers)")
    p.add_argument("--remat", default="nothing", choices=["nothing", "dots", "off"])
    p.add_argument("--kv-split", type=int, default=0,
                   help="GQA-aware mesh: factor the 16-way TP axis into (kv, rep)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="Megatron-SP activation sharding (a tag: the port's constrain "
                        "returns its input)")
    p.add_argument("--ssm-chunk", type=int, default=None)
    p.add_argument("--ssm-bf16", action="store_true")
    p.add_argument("--moe-cf", type=float, default=None,
                   help="MoE capacity factor override (memory knob)")
    p.add_argument("--grad-accum", type=int, default=None)
    p.add_argument("--out", default="experiments/dryrun_torch")
    args = p.parse_args()
    if args.ssm_bf16:
        try:
            check_scan_dtype(dataclasses.replace(get_config("falcon-mamba-7b"),
                                                 ssm_scan_dtype="bfloat16"))
        except ValueError as e:
            p.error(f"--ssm-bf16: {e}")
    if args.ssm_chunk:
        print(f"--ssm-chunk {args.ssm_chunk}: tagged and set in the config; the CUDA scan's "
              f"chunk is {SCAN_CHUNK} whatever the flag says")
    if args.seq_parallel:
        print("--seq-parallel: tagged; the port's constrain returns its input "
              "(launch/act_sharding.py), so no count changes")

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    remat = False if args.remat == "off" else args.remat

    rows = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                try:
                    r = run_cell(arch, shape, mesh_kind, sparse=args.sparse,
                                 cached_summaries=args.cached_summaries,
                                 sharded_sparse=args.sharded_sparse,
                                 fsdp=not args.no_fsdp, remat=remat,
                                 kv_split=args.kv_split,
                                 seq_parallel=args.seq_parallel,
                                 ssm_chunk=args.ssm_chunk, ssm_bf16=args.ssm_bf16,
                                 moe_cf=args.moe_cf,
                                 grad_accum=args.grad_accum, out_dir=args.out)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    r = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                         "ok": False, "error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()}
                    if args.out:
                        os.makedirs(args.out, exist_ok=True)
                        tag = f"{arch}_{shape}_{mesh_kind}_FAILED"
                        with open(os.path.join(args.out, tag + ".json"), "w") as f:
                            json.dump(r, f, indent=1)
                print(fmt_row(r), flush=True)
                rows.append(r)
    n_ok = sum(1 for r in rows if r.get("ok"))
    n_fit = sum(1 for r in rows if r.get("fits"))
    print(f"\n{n_ok}/{len(rows)} cells counted OK; {n_fit} of them fit "
          f"{RL.Hardware().hbm_per_chip / 1e9:.0f} GB a device")
    return 0 if n_ok == len(rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
