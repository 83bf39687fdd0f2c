"""Serving steps: prefill + single-token decode, and the samplers.

The port of ``repro.serve.serve_step``.  ``cache_pspecs`` needs the
sharding rules and comes with ``sharding.py``.
"""

from __future__ import annotations

import torch

from ..models import model


def make_serve_step(cfg):
    def serve_step(params, cache, tokens):
        return model.decode_step(params, cfg, cache, tokens)

    return serve_step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return model.prefill(params, cfg, batch, headroom=0)

    return prefill_step


def sample_greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_temperature(logits, generator: torch.Generator, temperature: float = 0.8):
    """One token a row from softmax(logits / temperature), drawn from
    ``generator`` (in place of the reference's ``jax.random`` key)."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(torch.int32)
