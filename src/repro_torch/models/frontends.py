"""Modality frontends for the audio and vlm families: stubs, as in the JAX
package.

The transformer backbone is the assigned architecture; the EnCodec tokenizer
(musicgen-large) and the InternViT vision tower (internvl2-76b) are
represented by precomputed frame / patch embeddings of width d_model, which
``transformer.forward``, ``prefill`` and ``decode_step`` take as
``{"embeds": ...}`` in place of token ids. ``make_frontend_embeds`` makes
real tensors; ``frontend_embed_spec`` the abstract one (no allocation).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def frontend_embed_spec(cfg, batch: int, seq: int):
    from repro_torch.launch.specs import ShapeDtypeStruct

    return ShapeDtypeStruct((batch, seq, cfg.d_model), cfg.activation_dtype())


def make_frontend_embeds(cfg, batch: int, seq: int, generator: torch.Generator,
                         device="cuda") -> torch.Tensor:
    """(batch, seq, d_model) random embeddings in the model dtype, of the
    JAX package's scale d_model^-0.5. ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    x = torch.randn((batch, seq, cfg.d_model), generator=generator, device=dev)
    return ((cfg.d_model ** -0.5) * x).to(cfg.activation_dtype())
