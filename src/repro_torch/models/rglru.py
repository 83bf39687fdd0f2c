"""RecurrentGemma / Griffin recurrent block (RG-LRU).

The port of ``repro.models.rglru``: the Real-Gated Linear Recurrent Unit
[arXiv:2402.19427],

    r_t = sigmoid(W_a x_t + b_a)         (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)         (input gate)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

gates in float32.  A diagonal linear recurrence: the prefill is a
log-depth doubling (Hillis-Steele) scan over the positions in place of the
reference's ``associative_scan`` (12 elementwise passes at S = 4,096; a
per-position loop would issue S steps a layer, and ``exp(cumsum(log a))``
underflows, since log a reaches -8 softplus(Lambda) a step); the decode is
a one-step update.  On a device mesh ``recurrent_block`` constrains the
recurrence's input at the reference's site (``lru`` over "model"), and
the gates, the scan and the decode step run on the cut width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding import constrain, matmul, unshard
from .layers import conv1d_causal

_C = 8.0


def _scan(a, h):
    """Inclusive scan of h_t = a_t h_{t-1} + h_t along axis 1, and the
    products of a: (a_sc, h_sc)."""
    S, d = a.shape[1], 1
    while d < S:
        h = torch.cat([h[:, :d], h[:, d:] + a[:, d:] * h[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, h


def _rg_lru(p, x, h0=None):
    """x: (B, S, W). Returns (y, h_last).  On a mesh the gates' products
    take x with its width whole (``sharding.unshard``), the columns of
    ``w_a`` and ``w_x`` cut as their specs say: DTensor of torch 2.11
    otherwise picks a layout that asks to turn a cut into a partial sum,
    which it cannot."""
    xw = unshard(x, -1)
    r = torch.sigmoid(matmul(xw, p["w_a"]).float() + p["b_a"].float())
    i = torch.sigmoid(matmul(xw, p["w_x"]).float() + p["b_x"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r  # (B,S,W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x.float())

    if x.shape[1] == 1 and h0 is not None:  # decode step
        h = a[:, 0] * h0.float() + gated[:, 0]
        return h[:, None].to(x.dtype), h.to(x.dtype)

    a_sc, h_sc = _scan(a, gated)
    if h0 is not None:
        h_sc = h_sc + a_sc * h0[:, None].float()
    return h_sc.to(x.dtype), h_sc[:, -1].to(x.dtype)


def recurrent_block(p, x, cfg, *, cache=None):
    """Griffin recurrent block: (gelu branch) * (conv -> RG-LRU branch).

    Returns (out, new_cache, {"state", "conv"}): new_cache None without a
    cache."""
    gate = F.gelu(matmul(x, p["w_gate"]), approximate="tanh")
    rec = constrain(matmul(x, p["w_rec"]), "batch", None, "lru")

    conv_cache = cache["conv"] if cache is not None else None
    rec, new_conv = conv1d_causal(rec, p["conv_w"], p["conv_b"], cache=conv_cache)

    h0 = cache["state"] if cache is not None else None
    rec, h_last = _rg_lru(p, rec, h0)

    y = matmul(gate * rec, p["w_out"])
    new_cache = {"conv": new_conv, "state": h_last} if cache is not None else None
    return y, new_cache, {"state": h_last, "conv": new_conv}
