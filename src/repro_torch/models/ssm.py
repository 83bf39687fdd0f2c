"""Mamba-2 (SSD, state-space duality) mixer block.

The port of ``repro.models.ssm``: the chunked SSD algorithm [Dao & Gu,
arXiv:2405.21060].  The sequence is split into Q-length chunks; the
intra-chunk terms are dense (Q x Q) masked products, the inter-chunk state
a recurrence over the chunks' (decay, state) pairs: a loop over the
S / Q chunks in place of the reference's ``associative_scan`` (16 at
S = 4,096).  The cast points are the reference's: ``scores`` and the
chunk weights in the input dtype, the chunk states and ``y_inter`` in
float32, the final or new state in the input dtype.

The decode path carries (conv window, ssm state) and is O(1) a token.
On a device mesh ``ssm_block`` constrains ``xBC`` at the reference's site
(``ssm_inner`` over "model"); the within-chunk ``cumsum`` runs on each
rank's rows (``_cumsum``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import sharding as shd
from ..sharding import constrain, flatten, matmul
from .layers import conv1d_causal, rms_norm


def _repeat(t, n: int, dim: int):
    """``jnp.repeat(t, n, axis=dim)``: each entry of axis ``dim`` repeated
    ``n`` times, by a broadcast view and one copy (no host sync)."""
    shape = t.shape
    return t.unsqueeze(dim + 1).expand(*shape[: dim + 1], n, *shape[dim + 1 :]).flatten(dim, dim + 1)


@shd.row_local
def _cumsum(a, dim: int):
    """``torch.cumsum`` along ``dim``, on a mesh on each rank's own rows:
    DTensor (torch 2.11) has no strategy for the ``flip`` of its backward."""
    return torch.cumsum(a, dim=dim)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """xh: (B, S, H, P); dt: (B, S, H) float32; A: (H,) negative;
    Bm/Cm: (B, S, G, N). Returns (y, final_state (B, H, P, N))."""
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hper = H // G
    nc = S // chunk

    # (B, nc, Q, ...): on a mesh whose cut of the sequence does not divide
    # the chunk count, the sequence is gathered first (``sharding.unflatten``)
    xc, dtc, Bc, Cc = (shd.unflatten(t, 1, (nc, chunk)) for t in (xh, dt, Bm, Cm))

    dA = dtc * A  # (B, nc, Q, H), negative
    cum = _cumsum(dA, 2)  # within-chunk cumulative

    # intra-chunk: scores[b,c,h,i,j] = C_i . B_j * exp(cum_i - cum_j) * dt_j
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)  # (B,nc,G,Q,Q)
    CB = _repeat(CB, hper, 2)  # (B,nc,H,Q,Q)
    # (B,nc,H,Q), contiguous: the (Q, Q) products then come out in the
    # default layout, which a placed run's DTensor assumes of them (a
    # shard that follows a transposed input fails the einsum's view)
    cum_t = cum.transpose(2, 3).contiguous()
    # <= 0 on the causal (lower) triangle; clamped so the masked upper
    # triangle cannot overflow exp
    decay = torch.exp(torch.clamp(cum_t[..., :, None] - cum_t[..., None, :], max=0.0))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    scores = torch.where(mask, CB * decay, 0.0) * dtc.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores.to(xh.dtype), xc)

    # chunk states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    w = (decay_to_end * dtc).to(xh.dtype)
    Bh = _repeat(Bc, hper, 3) if G != H else Bc
    states = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Bh.to(xh.dtype), xc, w)

    # inter-chunk recurrence: H_c = exp(sum dA_c) * H_{c-1} + S_c, and the
    # state entering each chunk
    chunk_decay = torch.exp(dA.sum(dim=2))  # (B, nc, H)
    states = states.float()
    h = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)  # (B,nc,H,P,N)

    # inter contribution: y_j += exp(cum_j) C_j . H_prev
    Ch = _repeat(Cc, hper, 3) if G != H else Cc
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch.float() * torch.exp(cum)[..., None], prev)
    y = y_intra + y_inter.to(xh.dtype)
    return flatten(y, 1, 2), h.to(xh.dtype)


def ssm_block(p, x, cfg, *, cache=None):
    """Mamba-2 mixer. x: (B, S, d). cache = dict(conv, state) for decode.

    Returns (out, new_cache, {"state", "conv"}): new_cache None without a
    cache."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * d
    G, N = cfg.ssm_n_groups, cfg.ssm_d_state
    P = cfg.ssm_head_dim
    H = d_in // P

    zxbcdt = matmul(x, p["in_proj"])
    z, xBC, dt = torch.split(zxbcdt, [d_in, d_in + 2 * G * N, H], dim=-1)
    xBC = constrain(xBC, "batch", None, "ssm_inner")

    conv_cache = cache["conv"] if cache is not None else None
    xBC, new_conv = conv1d_causal(xBC, p["conv_w"], p["conv_b"], cache=conv_cache)
    xBC = F.silu(xBC)

    xh = xBC[..., :d_in].reshape(B, S, H, P)
    Bm = xBC[..., d_in : d_in + G * N].reshape(B, S, G, N)
    Cm = xBC[..., d_in + G * N :].reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())  # (H,)

    if cache is None:
        chunk = min(cfg.ssm_chunk, S)
        pad = (-S) % chunk
        if pad:
            # zero-pad to a chunk multiple; dt = 0 on the padding keeps the
            # recurrence inert (decay 1, update 0), so the state is exact
            zf = lambda a: F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
            y, new_state = _ssd_chunked(zf(xh), zf(dt), A, zf(Bm), zf(Cm), chunk)
            y = y[:, :S]
        else:
            y, new_state = _ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    else:
        # O(1) decode: h = exp(dt A) h + dt B (x) x ; y = C . h
        h0 = cache["state"]  # (B, H, P, N)
        dt1 = dt[:, 0]  # (B, H)
        dA = torch.exp(dt1 * A)  # (B, H)
        Bh = _repeat(Bm[:, 0], H // G, 1) if G != H else Bm[:, 0]
        upd = torch.einsum("bhn,bhp,bh->bhpn", Bh.float(), xh[:, 0].float(), dt1)
        h1 = h0.float() * dA[..., None, None] + upd
        Ch = _repeat(Cm[:, 0], H // G, 1) if G != H else Cm[:, 0]
        y = torch.einsum("bhn,bhpn->bhp", Ch.float(), h1)[:, None]
        y = y.reshape(B, 1, H, P).to(x.dtype)
        new_state = h1.to(x.dtype)

    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = flatten(y, 2, 3)  # (B, S, d_in); on a mesh its gradient viewed back whole
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    out = matmul(y, p["out_proj"])
    new_cache = {"conv": new_conv, "state": new_state} if cache is not None else None
    return out, new_cache, {"state": new_state, "conv": new_conv}
