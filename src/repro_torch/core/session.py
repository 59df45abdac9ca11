"""Prefix ingest (real mode).

Ingest = the offline phase: run the model's causal forward over the shared
prefix once, chunk the per-layer KV into the store's layout as float16, keep
the probing keys. The layout is ContiguousChunks (ContiguousKV) or, for the
baseline engines, coarse blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chunking import ChunkMeta
from repro_torch.core.engine import PrefixSession
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.storage.layout import ContiguousChunkLayout, CoarseBlockLayout, KVGeometry
from repro_torch.storage.ssd import ChunkStore


def _geometry(cfg: ModelConfig) -> KVGeometry:
    return KVGeometry(n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, bytes_per_el=2)


def build_real_session(
    cfg: ModelConfig,
    params,
    prefix_tokens: np.ndarray,
    *,
    chunk_tokens: int = 16,
    coarse_blocks: bool = False,
    block_tokens: int = 64,
    in_memory: bool = False,
    device="cuda",
) -> PrefixSession:
    """Run the causal forward over the prefix on ``device`` and persist its
    float16 KV to the (file) store: as ContiguousChunks of ``chunk_tokens``,
    or with ``coarse_blocks`` as blocks of ``block_tokens`` (the baselines'
    layout). Only the last position's logits are computed: ingest discards
    them."""
    dev = resolve_device(device)
    n = len(prefix_tokens)
    geom = _geometry(cfg)
    if coarse_blocks:
        layout = CoarseBlockLayout(n, cfg.n_layers, geom, block_tokens)
    else:
        layout = ContiguousChunkLayout(n, cfg.n_layers, geom, chunk_tokens)
    store = ChunkStore(layout, dtype=np.float16, in_memory=in_memory)

    toks = torch.as_tensor(np.asarray(prefix_tokens), device=dev)[None]
    _, (k, v) = T.forward(params, {"tokens": toks}, cfg,
                          block_q=min(512, max(16, n)),
                          logits_positions="last", return_kv=True)
    k_all = k[:, 0].to(torch.float16).cpu().numpy()  # (L, n, n_kv, d)
    v_all = v[:, 0].to(torch.float16).cpu().numpy()
    for l in range(cfg.n_layers):
        store.write_layer(l, k_all[l], v_all[l])
    # the pruning/storage unit: the chunk, or the block of a coarse session
    meta = ChunkMeta(n_tokens=n,
                     chunk_tokens=block_tokens if coarse_blocks else chunk_tokens)
    return PrefixSession(cfg=cfg, prefix_len=n, meta=meta, store=store, probe=k_all)
