"""(arch x shape) cell definitions and abstract, sharded inputs.

The JAX package's ``repro/launch/specs.py``: the assigned shape set
  train_4k     seq 4096,   global_batch 256  -> train_step
  prefill_32k  seq 32768,  global_batch 32   -> prefill (serve)
  decode_32k   seq 32768,  global_batch 128  -> decode_step (1 new token)
  long_500k    seq 524288, global_batch 1    -> decode_step
and the inputs of each cell's step as :class:`ShapeDtypeStruct` leaves
with their ``NamedSharding``, the same shapes, dtypes and specs as JAX's.

Nothing here allocates: the params' shapes come from ``init_params`` on
``device="meta"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import dp_axes
from repro_torch.launch.sharding import (
    NamedSharding,
    P,
    batch_specs,
    param_shardings,
    serve_state_shardings,
)
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.tree import tree_flatten_with_path, tree_map, tree_replace_leaves


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """An abstract array: shape, dtype and, where it is laid out, its
    sharding (``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int
    grad_accum: int = 1


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256, grad_accum=8),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def _sds(shape, dtype, sharding=None) -> ShapeDtypeStruct:
    return ShapeDtypeStruct(tuple(shape), dtype, sharding)


@functools.lru_cache(maxsize=None)
def _param_shapes(cfg: ModelConfig):
    """(path, shape, dtype) of each params leaf, in JAX's order."""
    params = T.init_params(cfg, None, device="meta")
    return tuple((p, tuple(x.shape), x.dtype) for p, x in tree_flatten_with_path(params))


def param_specs_tree(cfg: ModelConfig, mesh, *, fsdp: bool = True):
    """Abstract params with shardings attached (no allocation)."""
    sh = param_shardings(cfg, mesh, fsdp=fsdp)
    shapes = {p: (shape, dtype) for p, shape, dtype in _param_shapes(cfg)}
    return tree_replace_leaves(sh, [_sds(*shapes[p], s) for p, s in tree_flatten_with_path(sh)])


def opt_specs_tree(param_tree, mesh):
    def f32(p):
        return _sds(p.shape, torch.float32, p.sharding)

    return {"m": tree_map(f32, param_tree), "v": tree_map(f32, param_tree),
            "step": _sds((), torch.int32, NamedSharding(mesh, P()))}


def batch_specs_tree(cfg: ModelConfig, mesh, spec: ShapeSpec, *, training: bool):
    sh = batch_specs(cfg, mesh, spec.batch, spec.seq, training=training)
    out: Dict[str, Any] = {}
    if cfg.frontend:
        out["embeds"] = _sds((spec.batch, spec.seq, cfg.d_model), cfg.activation_dtype(),
                             sh["embeds"])
    else:
        out["tokens"] = _sds((spec.batch, spec.seq), torch.int32, sh["tokens"])
    if training:
        out["labels"] = _sds((spec.batch, spec.seq), torch.int32, sh["labels"])
    return out


def serve_state_tree(cfg: ModelConfig, mesh, batch: int, max_len: int,
                     *, sparse_summaries: bool = False, chunk_tokens: int = 16):
    sh = serve_state_shardings(cfg, mesh, batch)
    dtype = cfg.activation_dtype()
    out: Dict[str, Any] = {"length": _sds((), torch.int32, NamedSharding(mesh, P()))}
    if cfg.has_attention:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        out["k"] = _sds(shape, dtype, sh["k"])
        out["v"] = _sds(shape, dtype, sh["v"])
        if sparse_summaries:
            m = max_len // chunk_tokens
            # kmean (L, b, m, n_kv, d): same layout family as the KV cache
            out["kmean"] = _sds((cfg.n_layers, batch, m, cfg.n_kv_heads, cfg.d_head), dtype,
                                NamedSharding(mesh, sh["k"].spec))
    if cfg.family in ("ssm", "hybrid"):
        out["ssm_h"] = _sds((cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state), torch.float32,
                            sh["ssm_h"])
        out["ssm_conv"] = _sds((cfg.n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype,
                               sh["ssm_conv"])
    return out


def decode_token_tree(cfg: ModelConfig, mesh, batch: int):
    dp = dp_axes(mesh)
    spec = P(dp, None) if batch >= 16 else P(None, None)
    if cfg.frontend:
        espec = P(dp, None, None) if batch >= 16 else P(None, None, None)
        return _sds((batch, 1, cfg.d_model), cfg.activation_dtype(), NamedSharding(mesh, espec))
    return _sds((batch, 1), torch.int32, NamedSharding(mesh, spec))


def input_specs(cfg: ModelConfig, shape_name: str, mesh, *,
                fsdp: bool = True, sparse_summaries: bool = False) -> Tuple[Any, ...]:
    """Abstract (sharded) inputs for the cell's step function, in call order."""
    spec = SHAPES[shape_name]
    params = param_specs_tree(cfg, mesh, fsdp=fsdp)
    if spec.kind == "train":
        opt = opt_specs_tree(params, mesh)
        batch = batch_specs_tree(cfg, mesh, spec, training=True)
        return params, opt, batch
    if spec.kind == "prefill":
        batch = batch_specs_tree(cfg, mesh, spec, training=False)
        state = serve_state_tree(cfg, mesh, spec.batch, spec.seq)
        return params, batch, state
    # decode
    token = decode_token_tree(cfg, mesh, spec.batch)
    state = serve_state_tree(cfg, mesh, spec.batch, spec.seq,
                             sparse_summaries=sparse_summaries)
    return params, token, state


def model_flops_global(cfg: ModelConfig, shape_name: str) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference)."""
    spec = SHAPES[shape_name]
    n = cfg.active_param_count()
    if spec.kind == "train":
        return 6.0 * n * spec.batch * spec.seq
    if spec.kind == "prefill":
        return 2.0 * n * spec.batch * spec.seq
    return 2.0 * n * spec.batch * 1
