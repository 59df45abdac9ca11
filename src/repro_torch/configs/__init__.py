"""Architecture config registry: ``get_config(name)``.

The ten assigned architectures and the paper's own Qwen2.5 evaluation
scales, as the JAX package registers them. Sources are cited per entry in
each module.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

from repro_torch.models.common import ModelConfig

from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba_7b
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3_4b
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite_moe
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba_1_5b
from repro_torch.configs.internvl2_76b import CONFIG as _internvl2_76b
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral_8x22b
from repro_torch.configs.musicgen_large import CONFIG as _musicgen_large
from repro_torch.configs.qwen2_5_7b import CONFIG as _qwen2_5_7b
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen2_5_14b
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen2_5_32b
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3_1_7b
from repro_torch.configs.yi_34b import CONFIG as _yi_34b

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _musicgen_large,
        _hymba_1_5b,
        _qwen3_1_7b,
        _qwen2_5_14b,
        _gemma3_4b,
        _yi_34b,
        _falcon_mamba_7b,
        _internvl2_76b,
        _granite_moe,
        _mixtral_8x22b,
        _qwen2_5_7b,
        _qwen2_5_32b,
    ]
}

ASSIGNED: List[str] = [
    "musicgen-large",
    "hymba-1.5b",
    "qwen3-1.7b",
    "qwen2.5-14b",
    "gemma3-4b",
    "yi-34b",
    "falcon-mamba-7b",
    "internvl2-76b",
    "granite-moe-3b-a800m",
    "mixtral-8x22b",
]


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
    )
    if cfg.has_attention:
        small.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)),
                     d_head=16)
        if cfg.sliding_window is not None:
            small["sliding_window"] = 16
    else:
        small.update(n_heads=0, n_kv_heads=0, d_head=0, d_ff=0)
    if cfg.family == "moe":
        # dropless at smoke scale so prefill/decode agree exactly with forward
        small.update(n_experts=4, top_k=min(2, cfg.top_k), moe_d_ff=32, d_ff=0,
                     moe_capacity_factor=2.0)
    if cfg.ssm_state:
        small.update(ssm_state=8, ssm_expand=2, ssm_conv=4)
    if cfg.local_global_ratio:
        small["local_global_ratio"] = cfg.local_global_ratio
        small["n_layers"] = cfg.local_global_ratio + 1  # one full pattern
    small["name"] = cfg.name + "-smoke"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
