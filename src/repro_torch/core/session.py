"""Prefix ingest (real mode) and synthetic workloads (sim mode).

Ingest = the offline phase: run the model's causal forward over the shared
prefix once, chunk the per-layer KV into the store's layout as float16, keep
the probing keys. The layout is ContiguousChunks (ContiguousKV) or, for the
baseline engines, coarse blocks.

A sim session has the same layout over a ``PlanStore`` (no data), and the
SyntheticWorkload generates per-(request, layer) token-importance vectors
with controlled cross-layer similarity, cross-period similarity and
cross-request overlap (calibrated to the paper's Fig. 7: 52-64 % coverage
between periods), so paper-scale simulations exercise the prefetch and cache
logic with realistic index dynamics. Both are the JAX package's, call for
call: the same seeds give the same fields.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.chunking import ChunkMeta
from repro_torch.core.engine import PlanStore, PrefixSession
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.storage.layout import ContiguousChunkLayout, CoarseBlockLayout, KVGeometry
from repro_torch.storage.ssd import ChunkStore


def _geometry(cfg: ModelConfig) -> KVGeometry:
    return KVGeometry(n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, bytes_per_el=2)


def prefix_digest(prefix_tokens: np.ndarray) -> str:
    """Content address of a prefix: sha256 over its token ids. Identical
    system prompts, whatever tenant submits them, digest identically, which
    is what lets the tier store dedupe them to one resident entry."""
    toks = np.ascontiguousarray(np.asarray(prefix_tokens, dtype=np.int64))
    return hashlib.sha256(toks.tobytes()).hexdigest()[:16]


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
    # the prefix tokens stay with the session: the compute-or-load planner
    # recomputes a head of the prefix KV from them instead of loading it
    return PrefixSession(cfg=cfg, prefix_len=n, meta=meta, store=store, probe=k_all,
                         tokens=np.asarray(prefix_tokens),
                         digest=prefix_digest(prefix_tokens))


def build_sim_session(
    cfg: ModelConfig,
    prefix_len: int,
    *,
    chunk_tokens: int = 16,
    coarse_blocks: bool = False,
    block_tokens: int = 64,
    digest: Optional[str] = None,
) -> PrefixSession:
    """A prefix of ``prefix_len`` tokens laid out as ``build_real_session``
    would, over a ``PlanStore``: no forward, no data, no probe keys."""
    geom = _geometry(cfg)
    if coarse_blocks:
        layout = CoarseBlockLayout(prefix_len, cfg.n_layers, geom, block_tokens)
    else:
        layout = ContiguousChunkLayout(prefix_len, cfg.n_layers, geom, chunk_tokens)
    meta = ChunkMeta(n_tokens=prefix_len,
                     chunk_tokens=block_tokens if coarse_blocks else chunk_tokens)
    return PrefixSession(cfg=cfg, prefix_len=prefix_len, meta=meta,
                         store=PlanStore(layout), probe=None, digest=digest)


class SyntheticWorkload:
    """Deterministic importance generator for sim mode.

    token score field = mix of a request-shared base (zipf-heavy) and
    request/layer noise; consecutive layers are random-walk correlated so the
    measured coverage between periods lands in the paper's 52-64 % band.
    """

    def __init__(
        self,
        prefix_len: int,
        n_layers: int,
        *,
        seed: int = 0,
        layer_drift: float = 0.15,
        request_drift: float = 0.35,
        zipf_alpha: float = 1.05,
    ):
        self.prefix_len = prefix_len
        self.n_layers = n_layers
        self.seed = seed
        self.layer_drift = layer_drift
        self.request_drift = request_drift
        rng = np.random.default_rng(seed)
        ranks = rng.permutation(prefix_len).astype(np.float64)
        self.base = 1.0 / np.power(1.0 + ranks, zipf_alpha)  # zipf mass by rank
        self._cache: Dict[int, np.ndarray] = {}

    def _request_field(self, request_id: int) -> np.ndarray:
        """(n_layers, prefix_len) score field for one request."""
        if request_id in self._cache:
            return self._cache[request_id]
        rng = np.random.default_rng((self.seed, request_id, 0xC0FFEE))
        req_noise = rng.exponential(1.0, self.prefix_len) * self.base.mean()
        score0 = (1 - self.request_drift) * self.base + self.request_drift * req_noise
        field = np.empty((self.n_layers, self.prefix_len))
        cur = score0
        for l in range(self.n_layers):
            step_noise = rng.exponential(1.0, self.prefix_len) * score0.mean()
            cur = (1 - self.layer_drift) * cur + self.layer_drift * step_noise
            field[l] = cur
        field /= field.sum(axis=1, keepdims=True)
        self._cache[request_id] = field
        if len(self._cache) > 8:  # bound memory
            self._cache.pop(next(iter(self._cache)))
        return field

    def token_scores(self, request_id: int, layer: int) -> np.ndarray:
        return self._request_field(request_id)[layer].copy()

    def decode_token_scores(self, request_id: int, step: int) -> np.ndarray:
        """Importance field for decode position `step` (0-indexed after the
        first token): random-walk drift away from the last prefill layer, so
        decode-time selection overlaps the resident set but keeps shifting,
        the cache-miss dynamics decode plans must price."""
        base = self._request_field(request_id)[-1]
        rng = np.random.default_rng((self.seed, request_id, step, 0xDEC0DE))
        noise = rng.exponential(1.0, self.prefix_len) * base.mean()
        cur = (1 - self.layer_drift) ** (step + 1) * base
        cur = cur + (1 - (1 - self.layer_drift) ** (step + 1)) * noise
        return cur / cur.sum()

    def chunk_mass(self, request_id: int, layer: int, sel_valid: np.ndarray) -> np.ndarray:
        n_valid = int(sel_valid.sum())
        mass = np.zeros(len(sel_valid))
        mass[:n_valid] = 1.0 / max(n_valid, 1)
        return mass
