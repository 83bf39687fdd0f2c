"""Train step: microbatched grad accumulation + AdamW.

The port of ``repro.train.train_step``.  ``make_train_step`` builds the
step as a plain function: each microbatch's gradients come from
``torch.autograd.grad`` of ``model.loss_fn`` and are summed in float32 in
the reference's order, then cast to the params' dtype; the step reads
nothing on the host.  ``jit_train_step`` builds the sharding rules for a
mesh and runs the step under them; nothing is compiled, and ``donate``
writes the new state into the old state's tensors in place.  On a mesh
with a ``DeviceMesh`` it places the state by ``state_pspecs`` and the
batch by ``batch_pspecs``, as the reference's ``in_shardings`` do, and
returns the placed state with the metrics whole (its ``out_shardings``
``(state_sh, None)``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import sharding as shd
from ..core.quotient_filter import resolve_device
from ..models import model
from ..models.schema import tree_leaves, tree_unflatten
from . import optimizer as optim


class TrainState(NamedTuple):
    params: dict
    opt: optim.OptState


def init_state(cfg, ocfg: optim.OptConfig, seed: int = 0, device=None) -> TrainState:
    params = model.init(cfg, seed, device)
    return TrainState(params=params, opt=optim.init(params, ocfg))


def abstract_state(cfg, ocfg: optim.OptConfig) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device (no memory)."""
    params = model.abstract(cfg)
    return TrainState(params=params, opt=optim.init(params, ocfg))


def from_numpy(cfg, ocfg: optim.OptConfig, state, device=None) -> TrainState:
    """A ``TrainState`` from the JAX package's, as numpy arrays in its
    structure (``params``; ``opt`` with ``mu``, ``nu``, ``step`` and
    ``ef_error``): the params, moments and residual by ``model.from_numpy``
    (bfloat16 leaves by their bits), the step as an int32 scalar."""
    params, opt = state[0], state[1]
    as_dtype = lambda dt: cfg.replace(param_dtype=dt)  # every leaf of one dtype
    ef = opt[3] if len(opt) > 3 else None
    return TrainState(
        params=model.from_numpy(cfg, params, device),
        opt=optim.OptState(
            mu=model.from_numpy(as_dtype(ocfg.opt_dtype), opt[0], device),
            nu=model.from_numpy(as_dtype(ocfg.opt_dtype), opt[1], device),
            step=torch.as_tensor(np.array(opt[2]), dtype=torch.int32,
                                 device=resolve_device(device)),
            ef_error=None if ef is None else model.from_numpy(as_dtype("bfloat16"), ef, device),
        ),
    )


def state_pspecs(cfg, ocfg: optim.OptConfig, rules) -> TrainState:
    pspec = model.partition_pspecs(cfg, rules)
    opt = optim.OptState(
        mu=pspec,
        nu=pspec,
        step=(),
        ef_error=pspec if ocfg.compress_grads else None,
    )
    return TrainState(params=pspec, opt=opt)


def batch_pspecs(cfg, rules, batch_tree):
    def spec(leaf):
        if leaf.ndim == 2:
            return rules.spec(("batch", None))
        return rules.spec(("batch", None, None))

    return {k: spec(v) for k, v in batch_tree.items()}


def make_train_step(cfg, ocfg: optim.OptConfig, *, microbatches: int = 1, remat=True):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss`` (``loss_fn``'s total, the microbatches' mean), ``grad_norm``
    and ``lr``, all device scalars."""

    def value_and_grad(params, batch):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        total, _ = model.loss_fn(tree_unflatten(params, leaves), cfg, batch, remat=remat)
        return total.detach(), list(torch.autograd.grad(total, leaves))

    def train_step(state: TrainState, batch):
        params = state.params
        if microbatches > 1:
            # microbatch m takes rows m b/mb ... (m + 1) b/mb - 1.  On a mesh
            # the rows are gathered before the view where the data axes do
            # not divide mb (``sharding.unflatten``), and each microbatch is
            # then cut as the batch was (``sharding.like``: a local slice)
            mbs = {k: shd.unflatten(v, 0, (microbatches, v.shape[0] // microbatches))
                   for k, v in batch.items()}
            gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=gacc[0].device)
            for m in range(microbatches):
                mb = {k: shd.like(v[m], batch[k]) for k, v in mbs.items()}
                mb_loss, g = value_and_grad(params, mb)
                gacc = [a + b.float() / microbatches for a, b in zip(gacc, g)]
                loss = loss + mb_loss / microbatches
            grads = [a.to(p.dtype) for a, p in zip(gacc, tree_leaves(params))]
            del gacc  # the float32 sums are not needed past the cast
        else:
            loss, grads = value_and_grad(params, batch)

        new_params, new_opt, om = optim.apply(
            params, tree_unflatten(params, grads), state.opt, ocfg
        )
        return TrainState(params=new_params, opt=new_opt), {"loss": loss, **om}

    return train_step


def jit_train_step(cfg, ocfg, mesh, *, microbatches=1, remat=True, seq_shard=True,
                   donate=True):
    """The step for ``mesh``, run under its sharding rules.  Returns (step,
    rules).  A mesh that is not one rank a device raises here
    (``sharding.check_devices``); the state and batch must lie on the
    mesh's device.  On a mesh with a ``DeviceMesh`` the step places the
    state and batch (plain or placed) and returns the placed state and
    whole metrics; every rank calls it.  With ``donate`` the new state is
    written into the (placed) passed state's tensors, which the step
    returns."""
    shd.check_devices(mesh)
    rules = shd.ShardingRules.for_config(mesh, cfg, seq_shard=seq_shard)
    step = make_train_step(cfg, ocfg, microbatches=microbatches, remat=remat)
    placed = mesh.device_mesh is not None
    sspec = state_pspecs(cfg, ocfg, rules) if placed else None

    def wrapped(state, batch):
        for t in tree_leaves(state) + list(batch.values()):
            if t.device.type != mesh.device.type:
                raise ValueError(f"a tensor on {t.device} given to a step on {mesh.device}")
        if placed:
            state = shd.place(state, sspec, mesh)
            batch = shd.place(batch, batch_pspecs(cfg, rules, batch), mesh)
        with shd.use_rules(rules):
            new, metrics = step(state, batch)
        metrics = {k: shd.whole(v) for k, v in metrics.items()}
        if not donate:
            return new, metrics
        with torch.no_grad():
            for old, fresh in zip(tree_leaves(state), tree_leaves(new)):
                old.copy_(fresh)
        return state, metrics

    return wrapped, rules
