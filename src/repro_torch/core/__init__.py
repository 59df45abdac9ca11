"""ContiguousKV core, PyTorch port: the paper's contribution as composable modules.

Import the modules themselves (``repro_torch.core.engine``, ``.session``, ...):
this package imports nothing when it is imported, so the kernels' plain
versions can use ``core.sparse_attention`` without an import cycle through the
engine. The four Re-Prefill engines are also exported here, and their module
is imported on the first access to one of them.
"""

ENGINES = ("ContiguousKVEngine", "ASLRUEngine", "ASH2OEngine", "IMPRESSEngine")
__all__ = list(ENGINES)


def __getattr__(name):
    if name in ENGINES:
        from repro_torch.core import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
