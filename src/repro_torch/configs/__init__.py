"""Architecture config registry: ``get_config(name)``.

The dense Qwen2.5 evaluation scales of the paper. Sources are cited per entry
in each module; the other families join the registry with their model code.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

from repro_torch.models.common import ModelConfig

from repro_torch.configs.qwen2_5_7b import CONFIG as _qwen2_5_7b
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen2_5_14b
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen2_5_32b

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in [_qwen2_5_7b, _qwen2_5_14b, _qwen2_5_32b]
}


def resolve_config_name(name: str) -> str:
    """Registry key for ``name``, tolerating punctuation variants.

    Names compare canonically on their alphanumerics
    (``qwen2_5_7b`` == ``qwen2.5-7b``)."""
    if name in _REGISTRY:
        return name
    canon = re.sub(r"[^a-z0-9]", "", name.lower())
    for key in _REGISTRY:
        if re.sub(r"[^a-z0-9]", "", key) == canon:
            return key
    raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[resolve_config_name(name)]


def list_configs() -> List[str]:
    return sorted(_REGISTRY)


def reduced_config(name: str, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    cfg = get_config(name)
    small = dict(
        n_layers=2,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)),
        d_head=16,
    )
    small["name"] = cfg.name + "-smoke"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
