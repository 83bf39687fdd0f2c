"""Shared model building blocks (pure functions over param dicts).

The port of ``repro.models.layers``.  Norms and rotary embeddings compute
in float32 and cast back to the input's dtype at the same points as the
JAX package, so bfloat16 activations round where the reference rounds.
``conv1d_causal`` comes with the SSM slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding import constrain, matmul, take_rows, unshard


def rms_norm(x, scale, eps: float = 1e-6, offset: float = 0.0):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (offset + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def _rotate(x, ang):
    """Rotate the two halves of ``x``'s last axis by ``ang`` (..., S, D/2)."""
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions3, sections, theta: float = 1_000_000.0):
    """Multimodal RoPE (Qwen2-VL): rotary dims split into (t, h, w)
    sections, each rotated by its own position stream.

    x: (B, S, H, D); positions3: (3, B, S) — equal streams for text.
    sections: per-section half-dim counts, sum == D/2.
    """
    D = x.shape[-1]
    half = D // 2
    assert sum(sections) == half, (sections, D)
    freqs = rope_frequencies(D, theta, x.device)  # (half,)
    # each rotary dim's position stream, by section: positions3's slices
    # concatenated on the host's static section widths
    pos = torch.cat(
        [positions3[i, ..., None].expand(*positions3.shape[1:], n)
         for i, n in enumerate(sections)],
        dim=-1,
    )  # (B, S, half)
    return _rotate(x, pos.float() * freqs)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _act(kind: str, x):
    if kind == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")  # geglu and gelu


def mlp(p, x, kind: str):
    """Gated (swiglu/geglu) or plain (gelu) MLP. x: (B, S, d)."""
    if kind in ("swiglu", "geglu"):
        h = _act(kind, matmul(x, p["wg"])) * matmul(x, p["wi"])
    else:
        h = _act(kind, matmul(x, p["wi"]))
    return matmul(constrain(h, "batch", "seq", "ffn"), p["wo"])


def embed_tokens(embedding, tokens, scale: bool, d_model: int):
    x = take_rows(embedding, tokens)
    if scale:
        # the factor rounded to the table's dtype first, as the reference does
        x = x * torch.tensor(d_model**0.5, dtype=x.dtype).item()
    return x


def unembed(p, x, tie_embeddings: bool):
    """x @ the (d_model, vocab) unembedding.  On a mesh the weight's
    d_model, cut over the data axes (FSDP), is gathered first, so that the
    product is cut by x's rows: DTensor's strategy costs only the inputs'
    redistribution, and would otherwise cut the contraction and sum the
    (B, chunk, V) logits over the ranks (the dry run counted 1.27 TB a
    device of all-reduce in Mamba2-130M's train_4k on 2 x 16 x 16)."""
    w = p["tok_embed"].T if tie_embeddings else p["lm_head"]
    return matmul(x, unshard(w, 0))


def conv1d_causal(x, w, b=None, cache=None):
    """Depthwise causal 1D conv. x: (B, S, C); w: (K, C).

    Returns (y, cache): the last K - 1 inputs (not outputs) as the cache.
    With ``cache`` (B, K-1, C): a single-step decode of x (B, 1, C)."""
    K = w.shape[0]
    if cache is not None:
        window = torch.cat([cache, x], dim=1)  # (B, K, C)
        y = torch.einsum("bkc,kc->bc", window, w)[:, None, :]
        if b is not None:
            y = y + b
        return y, window[:, 1:, :]
    pad = torch.zeros(x.shape[:1] + (K - 1,) + x.shape[2:], dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    # K shifted products, summed in the reference's order
    y = sum(xp[:, i : i + S, :] * w[i][None, None, :] for i in range(K))
    if b is not None:
        y = y + b
    return y, xp[:, -(K - 1) :, :] if K > 1 else None
