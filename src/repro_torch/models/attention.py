"""Attention: GQA/MQA/MHA, MLA (DeepSeek-V2), sliding-window, cross-attention.

The port of ``repro.models.attention``, in plain torch ops
that mirror the reference's math: scores in the input dtype cast to
float32, the softcap before the ``-1e30`` mask, a float32 softmax whose
weights are cast back to the values' dtype.  Two paths, as there:

* ``_attend_naive`` materializes (Sq, Sk) scores; short sequences and
  single-token decode.
* ``_attend_chunked`` is the online softmax over KV chunks with the
  query dimension also chunked, loops in place of ``lax.scan``/``lax.map``
  (no remat: serving has no backward pass).  Its values may be narrower
  than its queries (absorbed MLA attends latent values).
"""

from __future__ import annotations

import torch

from ..sharding import constrain, flatten, is_placed, like, local_over, matmul, unflatten, unshard
from .layers import apply_mrope, apply_rope, rms_norm

NEG_INF = -1e30


def _apply_mask(s, q_pos, k_pos, causal: bool, window: int):
    """Scores where a key is visible, ``NEG_INF`` elsewhere.  s: (B, KV, G, Sq, Sk)."""
    qp = q_pos[:, None, None, :, None]
    kp = k_pos[:, None, None, None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (qp - kp < window)
    return torch.where(valid, s, NEG_INF)


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def _scores(q, k, scale, softcap):
    """(B, KV, G, Sq, Sk) float32 scores of q (B, Sq, KV, G, Dh) against
    k (B, Sk, KV, Dh), the product in the inputs' dtype."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    return _softcap(s, softcap)


def _attend_naive(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale):
    # q: (B, Sq, KV, G, Dh), k/v: (B, Sk, KV, Dh)
    s = _apply_mask(_scores(q, k, scale, softcap), q_pos, k_pos, causal, window)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)


def _attend_chunked(
    q, k, v, q_pos, k_pos, *, causal, window, softcap, scale, q_chunk, kv_chunk
):
    B, Sq, KV, G, Dh = q.shape
    Sk = k.shape[1]
    Dv = v.shape[-1]
    outs = []
    for qs in range(0, Sq, q_chunk):
        qb, qpb = q[:, qs : qs + q_chunk], q_pos[:, qs : qs + q_chunk]
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, Dv), dtype=torch.float32, device=q.device)
        for ks in range(0, Sk, kv_chunk):
            kb, vb = k[:, ks : ks + kv_chunk], v[:, ks : ks + kv_chunk]
            s = _scores(qb, kb, scale, softcap)
            s = _apply_mask(s, qpb, k_pos[:, ks : ks + kv_chunk], causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vb.float())
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B, qc, KV, G, Dv)
    return torch.cat(outs, dim=1)


@local_over(0, 2)
def attend(
    q, k, v, q_pos, k_pos, *, causal=True, window=0, softcap=0.0,
    q_chunk=512, kv_chunk=1024, chunk_threshold=2048, scale=None,
):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq > chunk_threshold and Sq % q_chunk == 0:
        pad = (-Sk) % kv_chunk
        if pad:
            # ragged KV: pad with kpos = -1 slots, which the mask kills
            zk = (0, 0) * (k.ndim - 2) + (0, pad)
            k = torch.nn.functional.pad(k, zk)
            v = torch.nn.functional.pad(v, zk)
            k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        return _attend_chunked(
            q, k, v, q_pos, k_pos, causal=causal, window=window,
            softcap=softcap, scale=scale, q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
    return _attend_naive(
        q, k, v, q_pos, k_pos, causal=causal, window=window,
        softcap=softcap, scale=scale,
    )


@local_over(0, 2)
def _attend_decode(qg, ck, cv, kpos, k_new, v_new, q_pos, *, window, softcap, scale):
    """Single-token decode over a read-only cache plus the fresh K/V.

    The cache's and the new token's scores are softmaxed together, so the
    cache needs no write before attending; the caller commits the delta."""
    s_c = _scores(qg, ck, scale, softcap)
    s_n = _scores(qg, k_new, scale, softcap)
    valid = (kpos >= 0) & (kpos <= q_pos[:, :1])
    if window:
        valid = valid & (q_pos[:, :1] - kpos < window)
    s_c = torch.where(valid[:, None, None, None, :], s_c, NEG_INF)
    w = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    return torch.einsum(
        "bkgqs,bskd->bqkgd", w[..., :-1].to(cv.dtype), cv
    ) + torch.einsum("bkgqs,bskd->bqkgd", w[..., -1:].to(v_new.dtype), v_new)


# ---------------------------------------------------------------------------
# GQA attention layer (covers MHA and MQA as kv_heads extremes)
# ---------------------------------------------------------------------------


def project_heads(x, w):
    """``einsum("bsd,dhk->bshk", x, w)``: one product over the flattened
    (h·k) columns, then viewed as (h, k) heads, as the einsum computes it.
    On a mesh two cuts are gathered first (``sharding.unshard``,
    ``unflatten``): a cut of ``w``'s head dim, which flattened behind the
    heads is a strided cut whose every redistribution DTensor plans by a
    graph search (minutes a step on the 2 x 16 x 16 mesh); and a cut of
    the product's columns that does not fall between whole heads (8 KV
    heads' columns cut 16 ways, 28 or 20 heads'), which DTensor cannot
    view.  The weight's gradient comes back whole the same way
    (``sharding.flatten``)."""
    _, h, k = w.shape
    return unflatten(matmul(x, flatten(unshard(w, 2), 1, 2)), -1, (h, k))


def project_out(o, w):
    """``einsum("bshk,hkd->bsd", o, w)``: one product over the flattened
    (h·k) heads, as the einsum computes it.  On a mesh a cut of the head
    dim (decode's, with few KV heads) is gathered first in ``o`` and
    ``w``: flattened behind the heads it would be a strided cut (see
    :func:`project_heads`)."""
    return matmul(flatten(unshard(o, 3), 2, 3), flatten(unshard(w, 1), 0, 1))


def _query_groups(q, k, v, kv_heads: int):
    """(qg, k, v) for ``attend``: q (B, S, H, Dh) as (B, S, KV, G, Dh),
    each KV head's G query heads, beside k, v (B, S, KV, Dh).  On a mesh
    whose cut of the heads falls inside a group (32 heads over 8 KV heads,
    cut 16 ways) DTensor cannot view q so: each KV head is then repeated
    for its G query heads and cut as q is (a local slice of K/V that no
    mesh axis cuts), and the groups are (H, 1), the same scores."""
    B, S, H, Dh = q.shape
    if is_placed(q):
        from torch.distributed.tensor import Shard

        cuts = 1
        for i, p in enumerate(q.placements):
            if isinstance(p, Shard) and p.dim == 2:
                cuts *= q.device_mesh.size(i)
        if kv_heads % cuts:
            G = H // kv_heads
            k, v = (like(t.repeat_interleave(G, dim=2), q) for t in (k, v))
            return q.unsqueeze(3), k, v
    return q.reshape(B, S, kv_heads, H // kv_heads, Dh), k, v


def gqa_attention(
    p,
    x,
    cfg,
    positions,
    *,
    causal=True,
    window=0,
    cache=None,
    kv_from=None,
    is_cross=False,
    use_rope=True,
    mrope_positions=None,
):
    """x: (B, S, d). Returns (out, kv): kv (k, v) for prefill collection, or
    the fresh token's {"k", "v"} delta in decode.

    cache: dict(k, v, kpos) for decode; kv_from: encoder output for
    cross-attention (no cache write; cache holds precomputed enc K/V).
    """
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV

    q = constrain(project_heads(x, p["wq"]), "batch", None, "heads", "head_dim")
    if is_cross and cache is not None:  # cross-attn decode: cached enc K/V
        k, v = cache["k"], cache["v"]
    else:
        src = kv_from if is_cross else x
        k = project_heads(src, p["wk"])
        v = project_heads(src, p["wv"])
    k = constrain(k, "batch", None, "kv_heads", "head_dim")
    v = constrain(v, "batch", None, "kv_heads", "head_dim")

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if not (is_cross and cache is not None):
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if use_rope and not is_cross:
        if cfg.rope == "mrope" and mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
        elif cfg.rope in ("rope", "mrope"):
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and not is_cross:
        # decode: read-only cache + fresh-token merge; emit the delta
        o = _attend_decode(
            q.reshape(B, S, KV, G, Dh), cache["k"], cache["v"], cache["kpos"], k, v, positions,
            window=window, softcap=cfg.logit_softcap, scale=Dh**-0.5,
        )
        o = constrain(o.reshape(B, S, H, Dh), "batch", None, "heads", "head_dim")
        return project_out(o, p["wo"]), {"k": k, "v": v}

    if cache is not None:  # cross-attn decode
        k_pos = cache["kpos"]
    elif is_cross:
        k_pos = torch.arange(k.shape[1], device=x.device).expand(k.shape[:2])
    else:
        k_pos = positions
    qg, kh, vh = _query_groups(q, k, v, KV)
    o = attend(
        qg, kh, vh, positions, k_pos,
        causal=causal and not is_cross,
        window=window,
        softcap=cfg.logit_softcap,
    )
    o = constrain(o.reshape(B, S, H, Dh), "batch", None, "heads", "head_dim")
    return project_out(o, p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed KV with decode-time absorption
# ---------------------------------------------------------------------------


def mla_attention(p, x, cfg, positions, *, cache=None):
    """x: (B, S, d). Returns (out, kv): kv (c_kv, k_rope) for prefill
    collection, or the fresh token's {"c_kv", "k_rope"} delta in decode.

    cache: dict(c_kv, k_rope, kpos), the latent cache, for decode.  On a
    mesh (``heads`` cut over "model", the cache by batch) every op runs as
    DTensor propagates it: the reference has no constrain site here, and
    no op needs an explicit redistribution."""
    nope, rdim, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    scale = (nope + rdim) ** -0.5

    q = project_heads(x, p["wq"])  # (B,S,H,nope+rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = matmul(x, p["w_dkv"])  # (B,S,lora+rope)
    c_kv = rms_norm(ckv_full[..., :lora], p["kv_norm"], cfg.norm_eps)
    # the shared single-head rope key
    k_rope = apply_rope(ckv_full[..., None, lora:], positions, cfg.rope_theta)[:, :, 0, :]
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope, p["w_uk"])  # (B,S,H,lora)

    if cache is not None:
        # decode: latent and rope scores against the read-only cache and
        # the fresh token, softmaxed together; no cache-wide concat
        s_c = (
            torch.einsum("bshl,btl->bhst", q_lat, cache["c_kv"])
            + torch.einsum("bshr,btr->bhst", q_rope, cache["k_rope"])
        ).float() * scale
        s_n = (
            torch.einsum("bshl,btl->bhst", q_lat, c_kv)
            + torch.einsum("bshr,btr->bhst", q_rope, k_rope)
        ).float() * scale
        valid = (cache["kpos"] >= 0) & (cache["kpos"] <= positions[:, :1])
        s_c = torch.where(valid[:, None, None, :], s_c, NEG_INF)
        w = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
        ctx = torch.einsum(
            "bhst,btl->bshl", w[..., :-1].to(x.dtype), cache["c_kv"]
        ) + torch.einsum("bhst,btl->bshl", w[..., -1:].to(x.dtype), c_kv)
        o = torch.einsum("bshl,lhv->bshv", ctx, p["w_uv"])
        out = project_out(o, p["wo"])
        return out, {"c_kv": c_kv, "k_rope": k_rope}

    # Absorbed MLA == GQA with ONE latent KV head: queries in (lora + rope)
    # space, keys concat(c_kv, k_rope), values the latent c_kv itself
    q_all = torch.cat([q_lat, q_rope], dim=-1)[:, :, None]  # (B,S,KV=1,G=H,lora+rope)
    k_all = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
    ctx = attend(
        q_all, k_all, c_kv[:, :, None, :], positions, positions, causal=True, scale=scale
    )[:, :, 0]  # (B, S, H, lora)
    o = torch.einsum("bshl,lhv->bshv", ctx.to(x.dtype), p["w_uv"])
    out = project_out(o, p["wo"])
    return out, (c_kv, k_rope)
