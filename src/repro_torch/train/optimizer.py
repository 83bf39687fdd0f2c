"""AdamW with memory-dtype control, cosine schedule, grad clipping, and
optional int8 error-feedback gradient compression.

The port of ``repro.train.optimizer``.  Params, grads, moments and the
error-feedback residual are nested dicts of tensors with the params'
paths; ``step`` is an int32 scalar on the params' device, so a step
reads nothing on the host.  Moments can be stored in bfloat16
(``opt_dtype="bfloat16"``); updates are always computed in float32, at
the reference's cast points.  On placed leaves (DTensors) each gradient
is first brought to its param's placements; the update is elementwise,
so each rank updates its own shards with the step's replicated scalars,
and the compression scale is the whole leaf's amax, reduced over the
ranks as XLA reduces it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from .. import sharding as shd
from ..models.schema import tree_leaves


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    opt_dtype: str = "float32"  # moment storage dtype
    compress_grads: bool = False  # int8 + error feedback on the DP reduce


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor
    ef_error: Any = None  # error-feedback residual (compression)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure, leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _pick(tree, i: int):
    """The ``i``-th entry of each leaf (a tuple) of a nested dict."""
    return _map(lambda t: t[i], tree)


def init(params, ocfg: OptConfig) -> OptState:
    dt = getattr(torch, ocfg.opt_dtype)
    zeros = lambda p, d=dt: torch.zeros(p.shape, dtype=d, device=p.device)
    mu = _map(zeros, params)
    nu = _map(zeros, params)
    ef = _map(lambda p: zeros(p, torch.bfloat16), params) if ocfg.compress_grads else None
    device = tree_leaves(params)[0].device
    return OptState(mu=mu, nu=nu, step=torch.zeros((), dtype=torch.int32, device=device),
                    ef_error=ef)


def schedule(ocfg: OptConfig, step):
    """The learning rate at ``step`` (a Python int or an int32 tensor), a
    float32 scalar: linear warmup, then a cosine down to 0.1 of ``lr``."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - ocfg.warmup_steps) / max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return ocfg.lr * warm * (0.1 + 0.9 * cos)


def _global_norm(tree):
    """The float32 norm of all leaves, their squares summed in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


_PIECE = 1 << 26  # elements an elementwise pass takes at once


def _pieces(n: int) -> list:
    """Slices of a flattened leaf of ``n`` elements, ``_PIECE`` at a time:
    an update's float32 temporaries stay a few of these, not a few of the
    leaf (a 622 M-element embedding would take 2.5 GB each).  The passes
    are elementwise, so the values equal one pass over the whole leaf."""
    return [slice(i, min(i + _PIECE, n)) for i in range(0, n, _PIECE)]


def compress_int8(g, error):
    """Symmetric per-tensor int8 quantize-dequantize with error feedback.

    Models the compressed DP all-reduce: what crosses the network is the
    int8 payload + one scale; the residual is fed back next step, so the
    bias vanishes asymptotically (EF-SGD).  ``torch.round`` rounds half
    to even, as ``jnp.round`` does.  Returns (decompressed, new_error).
    A placed leaf is quantized shard by shard with the scale of the whole
    leaf (``sharding.all_max`` of the shards' maxima)."""
    g = shd.like(g, error)
    gl, el = shd.local(g), shd.local(error)
    gf, ef = gl.reshape(-1), el.reshape(-1)
    pieces = _pieces(gf.numel())
    amax = torch.stack([torch.amax(torch.abs(gf[sl].float() + ef[sl].float())) for sl in pieces])
    scale = torch.clamp(shd.all_max(torch.amax(amax), error), min=1e-12) / 127.0
    deq_out = torch.empty(gl.shape, dtype=gl.dtype, device=gl.device)
    err_out = torch.empty(gl.shape, dtype=torch.bfloat16, device=gl.device)
    for sl in pieces:
        g32 = gf[sl].float() + ef[sl].float()
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        deq_out.view(-1)[sl] = deq.to(gl.dtype)
        err_out.view(-1)[sl] = (g32 - deq).to(torch.bfloat16)
    return shd.from_local(deq_out, g), shd.from_local(err_out, error)


@torch.no_grad()
def apply(params, grads, opt: OptState, ocfg: OptConfig):
    """One AdamW step. Returns (new_params, new_opt, metrics)."""
    step = opt.step + 1
    grads = _map(shd.like, grads, params)  # placed: a param's own placements

    new_ef = opt.ef_error
    if ocfg.compress_grads:
        pairs = _map(compress_int8, grads, opt.ef_error)
        grads, new_ef = _pick(pairs, 0), _pick(pairs, 1)

    gnorm = _global_norm(grads)
    clip = torch.clamp(ocfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(ocfg, step)
    b1, b2 = ocfg.b1, ocfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    # replicated on a mesh: every rank's local value is the whole scalar
    clip, lr_t, bc1, bc2 = (shd.local(x) for x in (clip, lr, bc1, bc2))

    def upd_piece(p, g, mu, nu):
        g = g.float() * clip
        mu32 = b1 * mu.float() + (1 - b1) * g
        nu32 = b2 * nu.float() + (1 - b2) * g * g
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        delta = mhat / (torch.sqrt(vhat) + ocfg.eps) + ocfg.weight_decay * p.float()
        newp = p.float() - lr_t * delta
        return newp.to(p.dtype), mu32.to(mu.dtype), nu32.to(nu.dtype)

    def upd(p, g, mu, nu):  # on a mesh, each rank's own shards
        lp, lg, lmu, lnu = (shd.local(t) for t in (p, g, mu, nu))
        outs = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (lp, lmu, lnu))
        flat = [t.reshape(-1) for t in (lp, lg, lmu, lnu)]
        for sl in _pieces(lp.numel()):
            for out, piece in zip(outs, upd_piece(*(t[sl] for t in flat))):
                out.view(-1)[sl] = piece
        return tuple(shd.from_local(o, t) for o, t in zip(outs, (p, mu, nu)))

    out = _map(upd, params, grads, opt.mu, opt.nu)
    return (
        _pick(out, 0),
        OptState(mu=_pick(out, 1), nu=_pick(out, 2), step=step, ef_error=new_ef),
        {"grad_norm": gnorm, "lr": lr},
    )
