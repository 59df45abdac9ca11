"""ContiguousKV core, PyTorch port: the paper's contribution as composable modules.

Import the modules themselves (``repro_torch.core.engine``, ``.session``, ...):
this package imports nothing, so the kernels' plain versions can use
``core.sparse_attention`` without an import cycle through the engine.
"""
