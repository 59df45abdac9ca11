"""ContiguousChunk — the paper's unified granularity (Definition 4.1).

One abstraction governs pruning, storage, transfer and caching: a prefix of n
tokens is partitioned into m = ceil(n/c) chunks of c consecutive tokens
(c = 16 default). On TPU, c=16 x d_head=128 is exactly one bf16 VMEM tile —
the algorithmic unit and the hardware unit coincide (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChunkMeta:
    n_tokens: int
    chunk_tokens: int = 16

    @property
    def n_chunks(self) -> int:
        return -(-self.n_tokens // self.chunk_tokens)

    def chunk_of(self, token: int) -> int:
        return token // self.chunk_tokens

    def token_range(self, chunk: int) -> Tuple[int, int]:
        lo = chunk * self.chunk_tokens
        return lo, min(lo + self.chunk_tokens, self.n_tokens)

    def tokens_in(self, chunk: int) -> int:
        lo, hi = self.token_range(chunk)
        return hi - lo

    def chunks_for_tokens(self, tokens: Sequence[int]) -> List[int]:
        return sorted({int(t) // self.chunk_tokens for t in tokens})


def chunk_kv(k: np.ndarray, v: np.ndarray, c: int):
    """(n, n_kv, d) x2 -> (m, c, n_kv, d) x2, zero-padded tail."""
    n, n_kv, d = k.shape
    m = -(-n // c)
    pad = m * c - n
    if pad:
        z = np.zeros((pad, n_kv, d), k.dtype)
        k = np.concatenate([k, z], 0)
        v = np.concatenate([v, z], 0)
    return k.reshape(m, c, n_kv, d), v.reshape(m, c, n_kv, d)


def gather_chunks(chunks: dict, ids: Sequence[int]) -> np.ndarray:
    """Stack {id: (c, 2, n_kv, d)} records into (len(ids), c, 2, n_kv, d)."""
    return np.stack([chunks[int(i)] for i in ids], axis=0)
