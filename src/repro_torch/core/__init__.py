"""ContiguousKV core, PyTorch port: the paper's contribution as composable modules.

Import the modules themselves (``repro_torch.core.engine``, ``.session``, ...):
this package imports nothing when it is imported, so the kernels' plain
versions can use ``core.sparse_attention`` without an import cycle through the
engine. The four Re-Prefill engines, the compute-or-load planner, the prefix
digest and the sim mode's session, workload, store and backend are also
exported here, and their modules are imported on the first access to one of
them.
"""

ENGINES = ("ContiguousKVEngine", "ASLRUEngine", "ASH2OEngine", "IMPRESSEngine")
_EXPORTS = {
    **dict.fromkeys(ENGINES, "engine"), "PrefixSession": "engine", "ReprefillTrace": "engine",
    "HybridPlanner": "hybrid", "HybridDecision": "hybrid", "HYBRID_MODES": "hybrid",
    "build_real_session": "session", "prefix_digest": "session",
    "build_sim_session": "session", "SyntheticWorkload": "session", "PlanStore": "engine",
    "SimCompute": "backends",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f"repro_torch.core.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
