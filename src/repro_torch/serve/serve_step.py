"""Serving steps: prefill + single-token decode, and the samplers.

The port of ``repro.serve.serve_step``.  ``cache_pspecs`` gives a decode
cache's partition specs (tuples) by each leaf's name, as the reference
does, and ``place_cache`` places a cache by them on a device mesh: there
``prefill`` and ``decode_step`` run under ``sharding.use_rules`` on
placed params (``model.place``) and a placed cache.
"""

from __future__ import annotations

import torch

from .. import sharding as shd
from ..models import model


def cache_pspecs(cfg, rules, cache_tree):
    """Partition specs for a decode cache: batch over DP, kv heads or
    head_dim over TP; MLA's latents ``c_kv`` and ``k_rope`` by batch only
    (one latent head, nothing for TP to cut); recurrent states
    batch-sharded."""

    def spec(name, leaf):
        nd = leaf.ndim

        def tail(axes):
            return rules.spec((None,) * (nd - len(axes)) + axes, tuple(leaf.shape))

        if name in ("k", "v"):
            return tail(("batch", None, "kv_heads", "head_dim"))
        if name in ("c_kv", "k_rope", "conv"):
            return tail(("batch", None, None))
        if name == "kpos":
            return tail(("batch", None))
        if name == "state":
            return tail(("batch",) + (None,) * (min(nd, 4) - 1))
        return ()  # pos

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec(name, tree)

    return walk(cache_tree, None)


def place_cache(cache, cfg, rules):
    """A decode cache on the device mesh of ``rules.mesh``, each leaf by
    its ``cache_pspecs`` spec: a plain leaf distributed, a DTensor (what a
    placed prefill fills the cache with) redistributed."""
    return shd.place(cache, cache_pspecs(cfg, rules, cache), rules.mesh)


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
