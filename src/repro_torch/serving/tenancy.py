"""Multi-tenant serving: the engine classes by system name.

The JAX package's module also builds multi-tenant fleets (N prefixes, one
shared cache) for the sim driver and the heterogeneous fleet; those come
with the port's sim and fleet slices.
"""
from __future__ import annotations

from repro_torch.core.engine import (ASH2OEngine, ASLRUEngine, ContiguousKVEngine,
                                     IMPRESSEngine)

ENGINE_CLASSES = {
    "contiguous_kv": ContiguousKVEngine,
    "impress": IMPRESSEngine,
    "as_h2o_lfu": ASH2OEngine,
    "as_lru": ASLRUEngine,
}
