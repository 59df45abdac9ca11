"""Synthetic few-shot classification workloads shaped like the paper's
datasets (SST-2 / Subj / TREC / RTE): long shared few-shot prefix + short
per-request suffix ending in a label token. (The port's copy of the JAX
package's module, numpy only: the same tasks from the same seed in one
process. The seed mixes in ``hash(name)``, which Python salts per process
unless ``PYTHONHASHSEED`` is set, as the JAX package's does.)

Offline container => no real datasets; generation is deterministic and gives
the model learnable structure (label token correlates with a planted pattern
in the example body), so briefly-trained tiny models develop non-degenerate
attention for the quality benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

DATASETS: Dict[str, Dict] = {
    # n_classes and rough prefix lengths follow Table 1's relative sizes
    "sst2": dict(n_classes=2, examples=24, body_len=24),
    "subj": dict(n_classes=2, examples=26, body_len=26),
    "trec": dict(n_classes=6, examples=30, body_len=26),
    "rte": dict(n_classes=2, examples=20, body_len=40),
}

SEP = 1  # separator token
LABEL_BASE = 2  # label tokens occupy [2, 2+n_classes)


@dataclasses.dataclass
class FewShotTask:
    name: str
    prefix: np.ndarray  # shared few-shot context
    queries: List[Tuple[np.ndarray, int]]  # (suffix tokens, gold class)
    n_classes: int

    def label_token(self, cls: int) -> int:
        return LABEL_BASE + cls


def _example(rng, vocab: int, body_len: int, cls: int, n_classes: int) -> np.ndarray:
    """Body with a planted class-correlated pattern + separator + label."""
    body = rng.integers(LABEL_BASE + n_classes, vocab, body_len)
    marker = LABEL_BASE + n_classes + cls  # class-marker token id
    positions = rng.choice(body_len, size=max(2, body_len // 8), replace=False)
    body[positions] = marker
    return np.concatenate([body, [SEP, LABEL_BASE + cls, SEP]])


def make_task(name: str, vocab: int, *, n_queries: int = 16, seed: int = 0) -> FewShotTask:
    spec = DATASETS[name]
    rng = np.random.default_rng((seed, hash(name) & 0xFFFF))
    n_cls = spec["n_classes"]
    shots = []
    for i in range(spec["examples"]):
        shots.append(_example(rng, vocab, spec["body_len"], i % n_cls, n_cls))
    prefix = np.concatenate(shots)
    queries = []
    for _ in range(n_queries):
        cls = int(rng.integers(n_cls))
        ex = _example(rng, vocab, spec["body_len"], cls, n_cls)
        queries.append((ex[:-2], cls))  # strip the gold label + sep
    return FewShotTask(name=name, prefix=prefix, queries=queries, n_classes=n_cls)


def lm_batch_stream(vocab: int, batch: int, seq: int, *, seed: int = 0
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless LM pretraining batches over concatenated few-shot documents."""
    rng = np.random.default_rng(seed)
    names = list(DATASETS)
    buf = np.array([], dtype=np.int64)
    i = 0
    while True:
        while len(buf) < batch * (seq + 1):
            task = make_task(names[i % len(names)], vocab, n_queries=4,
                             seed=int(rng.integers(1 << 30)))
            doc = np.concatenate(
                [task.prefix] + [np.concatenate([q, [task.label_token(c), SEP]])
                                 for q, c in task.queries])
            buf = np.concatenate([buf, doc])
            i += 1
        chunk = buf[: batch * (seq + 1)].reshape(batch, seq + 1)
        buf = buf[batch * (seq + 1):]
        yield {"tokens": chunk[:, :-1].astype(np.int32),
               "labels": chunk[:, 1:].astype(np.int32)}
