"""Mixture-of-experts FFN with capacity-based sort dispatch.

The port of ``repro.models.moe``.  Tokens pick top-k experts; each row's
(token, expert) pairs are sorted by expert and gathered into a dense
capacity buffer, each expert runs a batched product, and the results
come back weighted, each token's k summed in ascending expert order
(``_fold``), the order of the reference's ``.at[].add``.  The backward of
the dispatch's row gather sums each token's k gradient rows in that
order too (``_Take``): a ``scatter_add`` adds them by atomics on the
card, in no fixed order, and a rerun would differ.  Shared experts
(DeepSeek-V2) run densely as one MLP.

The reference ``vmap``s its per-row dispatch over the batch; here the
rows go through one batched pass with the reference's order: pairs
flattened token-major, a stable sort on the expert, each expert's start
from a left ``searchsorted``, rank = position - start, kept while
rank < capacity.  The reference drops the rows past capacity by
scattering them to an out-of-range slot (``mode="drop"``); an
out-of-range index raises in torch, so they go to one dump row past
the buffer, sliced off.  No boolean-mask indexing and no host read: a
decode step stays free of syncs.

On a device mesh ``moe_ffn`` constrains ``x``, ``xe``, ``h``, ``ye`` and
``y`` at the reference's five sites, with its axes.  The top-k, the
dispatch and the combine are ``sharding.row_local``: after the first site
every rank holds whole rows, and each runs them on its own, as the
reference's ``vmap`` keeps them local to a data shard.  Before the
combine ``ye`` is gathered over the axis that cuts its experts, where
GSPMD inserts that all-gather.  Without a DeviceMesh every site and
wrapper returns its input, and the step issues the same torch operations.
"""

from __future__ import annotations

import torch

from .. import sharding as shd
from ..sharding import constrain, matmul
from .layers import _act


def expert_capacity(cfg, S: int) -> int:
    """Slots an expert takes a row, from static shapes, as the reference
    computes it: ``S k / E`` times the capacity factor, rounded up to a
    multiple of 8, at most ``S k``."""
    k = cfg.top_k
    capacity = max(1, int(S * k / cfg.n_experts * cfg.capacity_factor))
    return min(capacity + (-capacity) % 8, S * k)


def route(p, x, cfg):
    """Router probabilities (B, S, E) float32 and each token's top-k
    weights (renormalised) and experts (B, S, k)."""
    logits = matmul(x, p["router"]).float()
    return _top_k(logits, cfg.top_k)


@shd.row_local
def _top_k(logits, k: int):
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: the larger first, the lower expert first on a tie
    # (bf16 logits tie often); torch.topk leaves ties in no set order
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[..., :k], top_idx[..., :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_idx


@shd.row_local
def _dispatch(x, top_idx, top_w, n_experts: int, capacity: int):
    """Dispatch every row: x (B, S, d), top_idx/top_w (B, S, k).

    Returns (xe (B, E, C, d), combine metadata (slot, st, sw, keep), each
    (B, S k) in the sorted order); a dropped pair's slot is ``E C``, the
    dump row."""
    B, S, k = top_idx.shape
    d = x.shape[-1]
    dev = x.device
    flat_e = top_idx.reshape(B, S * k)
    flat_t = torch.arange(S, device=dev)[:, None].expand(S, k).reshape(S * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    st = flat_t[order]
    sw = top_w.reshape(B, S * k).gather(1, order)
    experts = torch.arange(n_experts, device=dev).expand(B, n_experts).contiguous()
    start = torch.searchsorted(se, experts)
    rank = torch.arange(S * k, device=dev) - start.gather(1, se)
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank, n_experts * capacity)

    rows = n_experts * capacity
    xe = x.new_zeros((B, rows + 1, d)).scatter_(
        1, slot[..., None].expand(B, S * k, d), _Take.apply(x, st, _token_pairs(st, k))
    )
    return xe[:, :rows].reshape(B, n_experts, capacity, d), (slot, st, sw, keep)


def _token_pairs(st, k: int):
    """Each token's k positions in the sorted order, ascending (its
    experts in ascending order): (B, S, k).  ``st`` holds every token k
    times, so a stable sort of it groups them."""
    B, n = st.shape
    return torch.sort(st, dim=-1, stable=True).indices.reshape(B, n // k, k)


def _fold(c, pairs):
    """c (B, S k, d), one row a pair in the sorted order -> (B, S, d): each
    token's k rows added one pick at a time in ``c``'s dtype, in ascending
    sorted position.  That is the order in which the CPU's sequential
    ``scatter_add_`` and the reference's ``.at[st].add`` add them, where the
    card's ``scatter_add_`` adds them by atomics in no fixed order."""
    d = c.shape[-1]
    y = c.new_zeros(pairs.shape[:2] + (d,))
    for j in range(pairs.shape[-1]):
        y = y + c.gather(1, pairs[..., j, None].expand(-1, -1, d))
    return y


def _take(x, st):
    """x (B, S, d) -> the rows of the pairs' tokens, (B, S k, d)."""
    return x.gather(1, st[..., None].expand(-1, -1, x.shape[-1]))


class _Take(torch.autograd.Function):
    """``_take``, whose backward sums each token's k gradient rows by
    ``_fold`` (gather's own backward adds them by atomics on the card)."""

    @staticmethod
    def forward(ctx, x, st, pairs):
        ctx.save_for_backward(pairs)
        return _take(x, st)

    @staticmethod
    def backward(ctx, g):
        return _fold(g, *ctx.saved_tensors), None, None


class _Fold(torch.autograd.Function):
    """``_fold``, whose backward is its adjoint ``_take``: one gather in
    place of k gathers' scatters."""

    @staticmethod
    def forward(ctx, c, st, pairs):
        ctx.save_for_backward(st)
        return _fold(c, pairs)

    @staticmethod
    def backward(ctx, g):
        return _take(g, *ctx.saved_tensors), None, None


@shd.row_local
def _combine(ye, meta, S: int):
    """Each pair's expert output, weighted, summed back onto its token in a
    fixed order (``_fold``): ye (B, E, C, d) -> (B, S, d); a dropped pair
    adds 0."""
    slot, st, sw, keep = meta
    B, E, C, d = ye.shape
    yf = ye.reshape(B, E * C, d)
    idx = torch.clamp(slot, max=E * C - 1)[..., None].expand(-1, -1, d)
    contrib = yf.gather(1, idx) * sw[..., None].to(yf.dtype)
    contrib = torch.where(keep[..., None], contrib, 0)
    return _Fold.apply(contrib, st, _token_pairs(st, st.shape[1] // S))


def _shared_experts(p, x, kind: str):
    """The shared experts as one dense MLP on the gathered ``x``, with
    ``layers.mlp``'s products and no constrain site, as the reference."""
    if kind in ("swiglu", "geglu"):
        h = _act(kind, matmul(x, p["shared_wg"])) * matmul(x, p["shared_wi"])
    else:
        h = _act(kind, matmul(x, p["shared_wi"]))
    return matmul(h, p["shared_wo"])


def moe_ffn(p, x, cfg):
    """x: (B, S, d) -> (B, S, d), plus the load-balance aux loss (float32)."""
    S = x.shape[1]
    E, k = cfg.n_experts, cfg.top_k

    # the sequence gathered once: every rank holds whole rows of its batch
    x = constrain(x, "batch", None, "embed")
    probs, top_w, top_idx = route(p, x, cfg)
    xe, meta = _dispatch(x, top_idx, top_w, E, expert_capacity(cfg, S))
    xe = constrain(xe, "batch", "experts", None, "embed")

    if "wg" in p:
        g = torch.einsum("becd,edf->becf", xe, p["wg"])
        h = _act(cfg.mlp_kind, g) * torch.einsum("becd,edf->becf", xe, p["wi"])
    else:
        h = _act(cfg.mlp_kind, torch.einsum("becd,edf->becf", xe, p["wi"]))
    h = constrain(h, "batch", "experts", None, "expert_ffn")
    ye = torch.einsum("becf,efd->becd", h, p["wo"])
    ye = constrain(ye, "batch", "experts", None, "embed")
    # every expert's rows whole for the row-local combine: an all-gather
    # over the axis that cuts the experts
    y = _combine(shd.unshard(ye, 1), meta, S)
    y = constrain(y, "batch", "seq", "embed")  # back to SP for the residual

    if cfg.n_shared_experts:
        y = y + _shared_experts(p, x, cfg.mlp_kind)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e, f_e from the
    # one-hot of the picks; on a mesh the means are DTensor reductions
    # over every rank's rows
    picks = top_idx[..., None] == torch.arange(E, device=x.device)
    frac = picks.float().sum(2).mean((0, 1)) / k
    aux = E * torch.sum(frac * probs.mean((0, 1)))
    return y, aux
