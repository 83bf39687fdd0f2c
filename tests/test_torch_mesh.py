"""The port's placement across a device mesh (``repro_torch.sharding``,
``model.place``, ``serve_step.place_cache``, ``jit_train_step`` and the
checkpoint on a mesh) against its own unplaced path and the JAX package.

Four ranks of a ``gloo`` process group, each a subprocess on one torch
thread, opened with a ``file://`` store in the module's temporary
directory, run every check in one group (``RANK_PROGRAM``) on a 2 x 2
("data", "model") mesh: the JAX mesh tests' configs
(``tests/test_distributed.py``), ``deepseek-7b`` smoke decode after an
8 x 32 prefill, a ``qwen3-8b`` smoke step (d_model 128, 2 layers) on an
8 x 64 batch, a ``gemma-7b`` smoke state saved from the 2 x 2 mesh and
restored onto a 1 x 4 one.  The MoE and MLA decoders the same way:
``deepseek-v2-lite-16b`` (8 experts over "model", MLA's latent cache, a
shared expert, the dense first layer) and ``grok-1-314b`` (one KV head,
so decode cuts ``head_dim``) smoke decode on 2 x 2, DeepSeek with 6
experts on 1 x 4 (experts replicated, ``expert_ffn`` cut), a DeepSeek
step on 2 x 2 and its state saved from 2 x 2 and restored onto 1 x 4.
The SSM, RG-LRU and encoder-decoder archs the same way: ``mamba2-130m``
(its SSM state and conv window), ``recurrentgemma-9b`` (its RG-LRU state
and windowed attention ring) and ``whisper-large-v3`` (its frames placed
with the prompts, its cross cache) decode and take a step on 2 x 2, and
a RecurrentGemma state is saved from 2 x 2 and restored onto 1 x 4.
The sites repaired so that full-width configs run on the 16 x 16 mesh
(``REPAIR_CASES``), each on the smoke shape and mesh whose placed run
failed there before: the queries' view into KV groups (1 x 4), the
microbatch split (4 x 1), the SSD's chunk and head views (1 x 4); and
``qwen2-vl-7b`` (M-RoPE, its step too) and ``starcoder2-15b`` on 2 x 2.
DeepSeek's leaves, and the three archs' (as phase 19 serves them), are
at their true fan-in (``at_true_fan_in``; at ``init``'s scale Mamba2's
placed logits sit 1.6e-5 and 2.5e-5 from the unplaced, each layer
magnifying a last-bit difference of its input).  Each rank writes its
results to the directory; the cases below assert on them.  The JAX package's single-device results, on the port's weights,
are computed once in this process while the ranks run.

Tolerances, fixed before the first run:

* mesh against the port unplaced: logits and loss max |Δ| / max |ref| <
  MESH_RTOL = 1e-5 (a row-parallel product sums its partials across
  ranks, which moves float32 in its last bits); the cache's K/V the same;
  ``grad_norm`` and the moments < GRAD_RTOL = 1e-3 a leaf, the params
  after the step by ``PERF.md`` §2's step rule (``step_params_close``);
* the port unplaced, and the mesh, against the JAX package: < RTOL = 1e-4;
* exact: greedy tokens, ``kpos``, ``pos``, ``step``, ``lr``, the
  restored leaves, an int8-compressed leaf's values, the experts each
  MoE layer routes every token to.
"""

import inspect
import math
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import sharding as tshd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as tattention
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import schema as tschema
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import serve_step as tserve
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESH_RTOL = 1e-5
RTOL = 1e-4
GRAD_RTOL = 1e-3
DECODE_ARCH, DECODE_SHAPE = "deepseek-7b", (8, 32)
TRAIN_ARCH, TRAIN_SHAPE = "qwen3-8b", (8, 64)
RESTORE_ARCH = "gemma-7b"
MOE_ARCH = "deepseek-v2-lite-16b"
# each MoE decode case: (arch, mesh); the fallback's 6 experts do not
# divide the 1 x 4 mesh's "model" axis, so they are replicated and
# expert_ffn is cut 4 ways
MOE_CASES = {"deepseek-v2-lite-16b": (MOE_ARCH, (2, 2)),
             "grok-1-314b": ("grok-1-314b", (2, 2)),
             "fallback": (MOE_ARCH, (1, 4))}
MOE_CHANGES = {"fallback": {"n_experts": 6}}
FAN_IN_CASES = ("deepseek-v2-lite-16b", "fallback")  # MLA's leaves at their true fan-in
# the SSM, RG-LRU and encoder-decoder archs, each at its true fan-in, as
# phase 19 serves them: decode and a step on 2 x 2
STATE_ARCHS = ("mamba2-130m", "recurrentgemma-9b", "whisper-large-v3")
STATE_RESTORE_ARCH = "recurrentgemma-9b"
# the repaired sites, each on a smoke shape whose placed run failed there
# before the repair: (arch, config changes, mesh, runs, microbatches, true
# fan-in).  4 heads over 2 KV heads cut 4 ways (the queries' view into KV
# groups); 8 rows cut 4 ways over "data" viewed as 2 microbatches of 4; an
# SSD of 6 heads whose 32 positions, cut 4 ways, are viewed as 2 chunks
REPAIR_CASES = {
    "kv-groups": ("qwen3-8b", {"n_kv_heads": 2}, (1, 4), ("decode", "step"), 1, False),
    "microbatches": ("qwen3-8b", {"d_model": 128, "n_layers": 2}, (4, 1), ("step",), 2, False),
    "ssd-chunks": ("mamba2-130m", {"d_model": 96, "ssm_head_dim": 32}, (1, 4),
                   ("decode", "step"), 1, True),
}
# archs pinned on 2 x 2: decode, and Qwen2-VL's step (M-RoPE's backward)
PINNED_ARCHS = ("qwen2-vl-7b", "starcoder2-15b")
RANK_TIMEOUT = 300

RANK_PROGRAM = r'''
import contextlib, math, os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)

from repro_torch import sharding as shd
from repro_torch.configs import get_config, make_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import model, moe
from repro_torch.models.schema import tree_leaves
from repro_torch.serve import serve_step
from repro_torch.train import optimizer as optim, train_step as ts
from repro_torch.train.checkpoint import CheckpointManager

# DEFINITIONS


def host(tree):  # every rank gathers (a collective): numpy, float32 or integer
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return [host(v) for v in tree]
    if tree is None:
        return None
    t = shd.whole(tree).detach()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def items(tree, path=()):  # (path, leaf) in tree_leaves' order
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (k,))
    elif isinstance(tree, tuple):
        for k, v in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from items(v, path + (str(k),))
    elif tree is not None:
        yield "/".join(path), tree


def layout(tree, spec_tree, mesh):  # (path, local shape, global shape, spec, placed as spec)
    specs = tree_leaves(spec_tree, is_leaf=lambda s: type(s) is tuple)
    return [(p, tuple(shd.local(t).shape), tuple(t.shape), s,
             shd.is_placed(t) and tuple(t.placements) == shd.placements(mesh, s))
            for (p, t), s in zip(items(tree), specs, strict=True)]


def refused(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


res = {}
mesh = make_debug_mesh(2, 2)
res["mesh"] = (mesh.device_mesh is not None, mesh.device.type, dict(mesh.shape))
res["refused"] = {s: refused(lambda: shd.make_mesh(s, ("data", "model"), "cpu"))
                  for s in ((2, 4), (1, 2), (4, 4))}
res["world_mesh_ok"] = refused(lambda: shd.check_devices(shd.Mesh({"data": 1, "model": 4},
                                                                  torch.device("cpu"))))
res["descriptions"] = (dryrun.one_card().device_mesh, make_production_mesh().device_mesh)
if rank == 0:
    cell = dryrun.run_cell(dryrun.Cell("qwen3-8b", "decode_32k", ("1x1",)))[0]
    res["dry_cell"] = {k: v for k, v in cell.items() if k != "seconds"}

x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
res["tuple_local"] = shd.place(x, (("data", "model"), None), mesh).to_local().numpy()
res["tuple_reversed"] = refused(lambda: shd.place(x, (("model", "data"), None), mesh))

@contextlib.contextmanager
def recorded_picks(picks):  # the experts each moe.route call picks, in call order
    route = moe.route

    def recording(p, x, cfg):
        out = route(p, x, cfg)
        picks.append(out[2])
        return out

    moe.route = recording
    try:
        yield picks
    finally:
        moe.route = route


def decode_run(cfg, mesh, params):
    """An 8 x 32 prefill (with its frames for an encoder-decoder) and one
    greedy step, unplaced and then placed on mesh; returns ({"unplaced",
    "placed"} gathered, the layout)."""
    rules = shd.ShardingRules.for_config(mesh, cfg, decode=True)
    batch = {k: torch.from_numpy(v) for k, v in decode_batch(cfg).items()}
    bspec = ts.batch_pspecs(cfg, rules, batch)
    picks0, picks1 = [], []
    with torch.no_grad():
        with recorded_picks(picks0):
            last0, cache0 = model.prefill(params, cfg, batch)
            tok0 = serve_step.sample_greedy(last0)[:, None]
            step0, cache0 = model.decode_step(params, cfg, cache0, tok0)
        pp = model.place(params, cfg, rules)
        with shd.use_rules(rules), recorded_picks(picks1):
            last1, cache1 = model.prefill(pp, cfg, shd.place(batch, bspec, mesh))
            tok1 = serve_step.sample_greedy(last1)[:, None]
        cache1 = serve_step.place_cache(cache1, cfg, rules)
        cspec = serve_step.cache_pspecs(cfg, rules, cache1)
        placed = (layout(pp, model.partition_pspecs(cfg, rules), mesh)
                  + layout(cache1, cspec, mesh))
        with shd.use_rules(rules), recorded_picks(picks1):
            step1, cache1 = model.decode_step(pp, cfg, cache1,
                                              shd.place(tok1, bspec["tokens"], mesh))
    return {"unplaced": host({"last": last0, "tok": tok0, "step": step0, "picks": tuple(picks0),
                              "next": serve_step.sample_greedy(step0), "cache": cache0}),
            "placed": host({"last": last1, "tok": tok1, "step": step1, "picks": tuple(picks1),
                            "next": serve_step.sample_greedy(step1), "cache": cache1})}, placed


# decode: deepseek-7b smoke, a placed prefill, the cache placed, one step
cfg = make_smoke(get_config("DECODE_ARCH"))
res["decode"], res["decode_layout"] = decode_run(cfg, mesh, model.init(cfg, 0, "cpu"))

# the MoE archs: DeepSeek-V2-Lite (MLA, a shared expert, the dense first
# layer; 8 experts over "model") and Grok-1 (one KV head: decode cuts
# head_dim) on 2 x 2, and DeepSeek with 6 experts on 1 x 4 (experts
# replicated, expert_ffn cut 4 ways)
mesh14 = shd.make_mesh((1, 4), ("data", "model"), "cpu")
res["moe_decode"], res["moe_layout"] = {}, {}
for case, (name, mesh_of) in MOE_CASES.items():
    cfg = make_smoke(get_config(name)).replace(**MOE_CHANGES.get(case, {}))
    params = model.init(cfg, 0, "cpu")
    if case in FAN_IN_CASES:
        at_true_fan_in(cfg, params)
    res["moe_decode"][case], res["moe_layout"][case] = decode_run(
        cfg, mesh if mesh_of == (2, 2) else mesh14, params)

# train: qwen3-8b smoke at d_model 128, 2 layers, one step
cfg = make_smoke(get_config("TRAIN_ARCH")).replace(d_model=128, n_layers=2)
ocfg = optim.OptConfig()
batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
st0, m0 = ts.make_train_step(cfg, ocfg)(ts.init_state(cfg, ocfg, 0, "cpu"), batch)
step, trules = ts.jit_train_step(cfg, ocfg, mesh, donate=False)
st1, m1 = step(ts.init_state(cfg, ocfg, 0, "cpu"), batch)
res["train_layout"] = layout(st1, ts.state_pspecs(cfg, ocfg, trules), mesh)
donating, _ = ts.jit_train_step(cfg, ocfg, mesh, donate=True)
passed = shd.place(ts.init_state(cfg, ocfg, 0, "cpu"), ts.state_pspecs(cfg, ocfg, trules), mesh)
st2, _ = donating(passed, batch)
res["donated"] = all(
    a.to_local().data_ptr() == b.to_local().data_ptr() and torch.equal(a.to_local(), c.to_local())
    for a, b, c in zip(tree_leaves(st2), tree_leaves(passed), tree_leaves(st1)))
res["train"] = {"unplaced": host({"state": st0, "metrics": m0}),
                "placed": host({"state": st1, "metrics": m1}),
                "metrics_placed": [shd.is_placed(v) for v in m1.values()]}
# a MoE train step: deepseek-v2-lite smoke on 2 x 2, and loss_fn's aux
cfg = make_smoke(get_config("MOE_ARCH"))
params = model.init(cfg, 0, "cpu")
at_true_fan_in(cfg, params)
state = lambda: ts.TrainState(params=params, opt=optim.init(params, ocfg))
batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
st0, m0 = ts.make_train_step(cfg, ocfg)(state(), batch)
step, trules = ts.jit_train_step(cfg, ocfg, mesh, donate=False)
st1, m1 = step(state(), batch)
res["moe_train_layout"] = layout(st1, ts.state_pspecs(cfg, ocfg, trules), mesh)
with torch.no_grad():
    _, aux0 = model.loss_fn(params, cfg, batch, remat=False)
    with shd.use_rules(trules):
        _, aux1 = model.loss_fn(model.place(params, cfg, trules), cfg,
                                shd.place(batch, ts.batch_pspecs(cfg, trules, batch), mesh),
                                remat=False)
res["moe_train"] = {"unplaced": host({"state": st0, "metrics": m0, "aux": aux0["aux"]}),
                    "placed": host({"state": st1, "metrics": m1, "aux": aux1["aux"]})}

g = torch.randn(16, 24, generator=torch.Generator().manual_seed(3))
e = torch.randn(16, 24, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16) * 0.01
pe = shd.place(e, ("data", "model"), mesh)
res["compress"] = {"unplaced": host(optim.compress_int8(g, e)),
                   "placed": host(optim.compress_int8(shd.place(g, (None, "model"), mesh), pe))}

# the SSM, RG-LRU and encoder-decoder archs: decode and a step on 2 x 2
for key in ("state_decode", "state_layout", "state_train", "state_train_layout"):
    res[key] = {}
for name in STATE_ARCHS:
    cfg = make_smoke(get_config(name))
    params = at_true_fan_in(cfg, model.init(cfg, 0, "cpu"))
    res["state_decode"][name], res["state_layout"][name] = decode_run(cfg, mesh, params)
    state = lambda: ts.TrainState(params=params, opt=optim.init(params, ocfg))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    st0, m0 = ts.make_train_step(cfg, ocfg)(state(), batch)
    step, trules = ts.jit_train_step(cfg, ocfg, mesh, donate=False)
    st1, m1 = step(state(), batch)
    res["state_train_layout"][name] = layout(st1, ts.state_pspecs(cfg, ocfg, trules), mesh)
    res["state_train"][name] = {"unplaced": host({"state": st0, "metrics": m0}),
                                "placed": host({"state": st1, "metrics": m1})}

# the repaired sites (REPAIR_CASES) on their own meshes, and the archs
# pinned on 2 x 2 (PINNED_ARCHS), each placed against unplaced


def step_run(cfg, mesh, params, microbatches=1):
    """One step from ``params``' fresh state, unplaced and placed on mesh."""
    state = lambda: ts.TrainState(params=params, opt=optim.init(params, ocfg))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    st0, m0 = ts.make_train_step(cfg, ocfg, microbatches=microbatches)(state(), batch)
    step, _ = ts.jit_train_step(cfg, ocfg, mesh, microbatches=microbatches, donate=False)
    st1, m1 = step(state(), batch)
    return {"unplaced": host({"state": st0, "metrics": m0}),
            "placed": host({"state": st1, "metrics": m1})}


res["repair"], res["pinned"] = {}, {}
for case, (name, changes, shape, runs, mb, fan_in) in REPAIR_CASES.items():
    cfg = make_smoke(get_config(name)).replace(**changes)
    params = model.init(cfg, 0, "cpu")
    if fan_in:
        at_true_fan_in(cfg, params)
    rmesh = shd.make_mesh(shape, ("data", "model"), "cpu")
    res["repair"][case] = {}
    if "decode" in runs:
        res["repair"][case]["decode"] = decode_run(cfg, rmesh, params)[0]
    if "step" in runs:
        res["repair"][case]["step"] = step_run(cfg, rmesh, params, mb)
for name in PINNED_ARCHS:
    cfg = make_smoke(get_config(name))
    params = model.init(cfg, 0, "cpu")
    res["pinned"][name] = {"decode": decode_run(cfg, mesh, params)[0]}
    if cfg.rope == "mrope":
        res["pinned"][name]["step"] = step_run(cfg, mesh, params)

# elastic restore: gemma-7b smoke saved from the 2 x 2 mesh, restored onto 1 x 4
cfg = make_smoke(get_config("RESTORE_ARCH"))
state = ts.init_state(cfg, ocfg, 0, "cpu")
placed = shd.place(state, ts.state_pspecs(cfg, ocfg, shd.ShardingRules.for_config(mesh, cfg)), mesh)
mgr = CheckpointManager(os.path.join(out, "ckpt_mesh"))
mgr.save(7, placed)
mgr.save(8, placed, background=True)  # rank 0 writes on a thread; the ranks meet at wait
mgr.wait()
res["latest"] = mgr.latest_step()
if rank == 0:
    CheckpointManager(os.path.join(out, "ckpt_plain")).save(7, state)
dist.barrier()
mesh2 = mesh14
spec2 = ts.state_pspecs(cfg, ocfg, shd.ShardingRules.for_config(mesh2, cfg))
got = mgr.restore(7, ts.abstract_state(cfg, ocfg), shardings=(mesh2, spec2))
res["restore_layout"] = layout(got, spec2, mesh2)


def bits(t):
    t = shd.whole(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


res["restore_equal"] = [
    all(a.dtype == b.dtype and torch.equal(bits(a), bits(b))
        for a, b in zip(tree_leaves(restored), tree_leaves(state)))
    for restored in (got, mgr.restore(8, ts.abstract_state(cfg, ocfg), shardings=(mesh2, spec2)))]

# the MoE state: saved from 2 x 2 (experts cut over "model" 2), restored onto
# 1 x 4 (experts cut 4 ways)
cfg = make_smoke(get_config("MOE_ARCH"))
state = ts.init_state(cfg, ocfg, 0, "cpu")
mgr = CheckpointManager(os.path.join(out, "ckpt_moe"))
mgr.save(3, shd.place(state, ts.state_pspecs(cfg, ocfg, shd.ShardingRules.for_config(mesh, cfg)),
                      mesh))
spec2 = ts.state_pspecs(cfg, ocfg, shd.ShardingRules.for_config(mesh2, cfg))
got = mgr.restore(3, ts.abstract_state(cfg, ocfg), shardings=(mesh2, spec2))
res["moe_restore_layout"] = layout(got, spec2, mesh2)
res["moe_restore_equal"] = all(a.dtype == b.dtype and torch.equal(bits(a), bits(b))
                               for a, b in zip(tree_leaves(got), tree_leaves(state)))

# a RecurrentGemma state: saved from 2 x 2 (the RG-LRU width cut over "model"
# 2), restored onto 1 x 4 (cut 4 ways)
cfg = make_smoke(get_config("STATE_RESTORE_ARCH"))
state = ts.init_state(cfg, ocfg, 0, "cpu")
mgr = CheckpointManager(os.path.join(out, "ckpt_rec"))
mgr.save(4, shd.place(state, ts.state_pspecs(cfg, ocfg, shd.ShardingRules.for_config(mesh, cfg)),
                      mesh))
spec2 = ts.state_pspecs(cfg, ocfg, shd.ShardingRules.for_config(mesh2, cfg))
got = mgr.restore(4, ts.abstract_state(cfg, ocfg), shardings=(mesh2, spec2))
res["rec_restore_layout"] = layout(got, spec2, mesh2)
res["rec_restore_equal"] = all(a.dtype == b.dtype and torch.equal(bits(a), bits(b))
                               for a, b in zip(tree_leaves(got), tree_leaves(state)))

with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def leaves(tree) -> list:
    """The arrays of a rank's result (dicts in sorted key order, lists)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def at_true_fan_in(cfg, params):
    """Scale in place each leaf that ``init`` draws at 1/sqrt(fan_in) to the
    fan-in of its product, the leaf's first axis that is neither ``layers``
    nor ``experts`` (``chip_smoke.at_true_fan_in``).  A stacked leaf's
    first axis is the layer axis, so at ``init``'s scale MLA's queries and
    latent keys come out several times too large: with no q-norm its
    scores are nearly one-hot, and each layer magnifies a last-bit
    difference of its input (phase 18 brings DeepSeek to this scale on
    the card for the same reason)."""
    from repro_torch.models import model as _model
    from repro_torch.models import schema as _schema

    for path, p in _schema.tree_items(_model.schema(cfg)):
        if p.init != "fan_in" or p.scale is not None:
            continue
        fan_in = next(n for n, a in zip(p.shape, p.axes) if a not in ("layers", "experts"))
        leaf = params
        for key in path:
            leaf = leaf[key]
        leaf.mul_(math.sqrt(p.shape[0] / fan_in))
    return params


def program() -> str:
    defs = "\n".join([f"MOE_CASES = {MOE_CASES!r}", f"MOE_CHANGES = {MOE_CHANGES!r}",
                      f"REPAIR_CASES = {REPAIR_CASES!r}", f"PINNED_ARCHS = {PINNED_ARCHS!r}",
                      f"FAN_IN_CASES = {FAN_IN_CASES!r}", f"STATE_ARCHS = {STATE_ARCHS!r}",
                      inspect.getsource(at_true_fan_in), inspect.getsource(decode_batch),
                      inspect.getsource(train_batch)])
    return (RANK_PROGRAM.replace("# DEFINITIONS", defs)
            .replace('"STATE_RESTORE_ARCH"', repr(STATE_RESTORE_ARCH))
            .replace('"MOE_ARCH"', repr(MOE_ARCH))
            .replace('"DECODE_ARCH"', repr(DECODE_ARCH))
            .replace("DECODE_SHAPE", repr(DECODE_SHAPE))
            .replace('"TRAIN_ARCH"', repr(TRAIN_ARCH)).replace("TRAIN_SHAPE", repr(TRAIN_SHAPE))
            .replace('"RESTORE_ARCH"', repr(RESTORE_ARCH)))


def decode_batch(cfg):
    """The decode's prompts (``DECODE_SHAPE``) and, for an encoder-decoder,
    its frames drawn after them; numpy."""
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, DECODE_SHAPE).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            size=(DECODE_SHAPE[0], cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def train_batch(cfg):
    """A step's tokens and targets (``TRAIN_SHAPE``) and, for an
    encoder-decoder, its frames drawn after them; numpy."""
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, TRAIN_SHAPE).astype(np.int32)
             for k in ("tokens", "targets")}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            size=(TRAIN_SHAPE[0], cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def jax_decode(params_np, name=DECODE_ARCH):
    """The JAX package's prefill and greedy decode step on the port's weights."""
    cfg = jconfigs.make_smoke(jconfigs.get_config(name))
    params = jax.tree.map(jnp.asarray, params_np)
    batch = {k: jnp.asarray(v) for k, v in decode_batch(cfg).items()}
    last, cache = jmodel.prefill(params, cfg, batch, remat=False)
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
    step, _ = jmodel.decode_step(params, cfg, cache, tok)
    return {"last": np.asarray(last), "tok": np.asarray(tok), "step": np.asarray(step)}


def jax_train(params_np, cfg=None):
    """The JAX package's single-device step from the port's initial state."""
    if cfg is None:
        cfg = jconfigs.make_smoke(jconfigs.get_config(TRAIN_ARCH)).replace(d_model=128,
                                                                           n_layers=2)
    ocfg = joptim.OptConfig()
    params = jax.tree.map(jnp.asarray, params_np)
    batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
    _, m = jax.jit(jts.make_train_step(cfg, ocfg))(
        jts.TrainState(params=params, opt=joptim.init(params, ocfg)), batch)
    out = {k: np.asarray(v) for k, v in m.items()}
    if cfg.is_moe:
        _, parts = jax.jit(lambda p, b: jmodel.loss_fn(p, cfg, b, remat=False))(params, batch)
        out["aux"] = np.asarray(parts["aux"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the four ranks, compute the JAX side meanwhile, then read each
    rank's results.  Every rank process is ended before this returns."""
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", program(), str(r), str(WORLD),
                               str(out / "store"), str(out)],
                              cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        dcfg = tconfigs.make_smoke(tconfigs.get_config(DECODE_ARCH))
        tcfg = tconfigs.make_smoke(tconfigs.get_config(TRAIN_ARCH)).replace(d_model=128,
                                                                            n_layers=2)
        mcfg = tconfigs.make_smoke(tconfigs.get_config(MOE_ARCH))
        moe_np = tmodel.to_numpy(at_true_fan_in(mcfg, tmodel.init(mcfg, 0, "cpu")))
        want = {"decode": jax_decode(tmodel.to_numpy(tmodel.init(dcfg, 0, "cpu"))),
                "train": jax_train(tmodel.to_numpy(tmodel.init(tcfg, 0, "cpu"))),
                "moe_decode": jax_decode(moe_np, MOE_ARCH),
                "moe_train": jax_train(moe_np,
                                       jconfigs.make_smoke(jconfigs.get_config(MOE_ARCH)))}
        for name in STATE_ARCHS:
            scfg = tconfigs.make_smoke(tconfigs.get_config(name))
            state_np = tmodel.to_numpy(at_true_fan_in(scfg, tmodel.init(scfg, 0, "cpu")))
            want[name] = {"decode": jax_decode(state_np, name),
                          "train": jax_train(state_np,
                                             jconfigs.make_smoke(jconfigs.get_config(name)))}
        rcs = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, rc in enumerate(rcs):
        assert rc == 0, f"rank {r} exited {rc}:\n{(out / f'rank{r}.log').read_text()[-4000:]}"
    got = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))  # written by the rank program above
    return {"ranks": got, "jax": want, "dir": out, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def test_decode_on_mesh_matches_unplaced(ranks):
    """Each rank's gathered logits, greedy tokens and cache against the
    unplaced prefill and step (the JAX mesh test's own criterion)."""
    for res in ranks["ranks"]:
        decode_matches(res["decode"]["placed"], res["decode"]["unplaced"])


def decode_matches(got, want) -> None:
    """Logits and the cache's K/V (or latents) within MESH_RTOL; greedy
    tokens, ``kpos`` and ``pos`` exact."""
    assert rel_err(got["last"], want["last"]) < MESH_RTOL
    assert rel_err(got["step"], want["step"]) < MESH_RTOL
    for key in ("tok", "next"):
        np.testing.assert_array_equal(got[key], want[key])

    def cache(g, w, path=()):
        for k in w:
            if isinstance(w[k], dict):
                cache(g[k], w[k], path + (k,))
            elif k in ("kpos", "pos"):
                np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(path + (k,)))
            else:
                assert rel_err(g[k], w[k]) < MESH_RTOL, path + (k,)

    cache(got["cache"], want["cache"])
    assert int(got["cache"]["pos"]) == DECODE_SHAPE[1] + 1


def test_decode_matches_jax_single_device(ranks):
    """The port unplaced, and on the mesh, against the JAX package's prefill
    and step on one device, on the same weights."""
    want = ranks["jax"]["decode"]
    for side in ("unplaced", "placed"):
        got = ranks["ranks"][0]["decode"][side]
        np.testing.assert_array_equal(got["tok"], want["tok"])
        assert rel_err(got["last"], want["last"]) < RTOL, side
        assert rel_err(got["step"], want["step"]) < RTOL, side


def test_decode_placements_follow_the_specs(ranks):
    """Every param and cache leaf of each decode (the dense one, the MoE
    cases, MLA's latents among them, and the SSM, RG-LRU and
    encoder-decoder archs, their states, conv windows and cross caches) is
    a DTensor placed as its spec says, its local shard the JAX shard's
    shape (``shards``)."""
    meshes = {(2, 2): tshd.make_mesh((2, 2), ("data", "model"), "cpu"),
              (1, 4): tshd.make_mesh((1, 4), ("data", "model"), "cpu")}
    for res in ranks["ranks"]:
        cases = [(res["decode_layout"], (2, 2))] + [
            (res["moe_layout"][case], sizes) for case, (_, sizes) in MOE_CASES.items()] + [
            (res["state_layout"][name], (2, 2)) for name in STATE_ARCHS]
        for rows, sizes in cases:
            assert rows
            for path, local, shape, spec, as_spec in rows:
                assert as_spec, path
                cuts = tshd.shards(meshes[sizes], spec) + (1,) * (len(shape) - len(spec))
                assert local == tuple(n // c for n, c in zip(shape, cuts)), (path, spec)
    # the deepseek cache's kv_heads dim is cut over "model": the in-place
    # writes went to sharded leaves
    kv = [row for row in ranks["ranks"][0]["decode_layout"] if row[0].endswith("attn/k")]
    assert kv and all("model" in row[3] for row in kv)


# ---------------------------------------------------------------------------
# the MoE and MLA decoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_decode_on_mesh_matches_unplaced(ranks, case):
    """A MoE arch's placed prefill and step against the unplaced port: the
    decode criteria, and each MoE layer's routed experts (every
    ``moe.route`` call, prefill then step) equal."""
    cfg = tconfigs.make_smoke(tconfigs.get_config(MOE_CASES[case][0]))
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    for res in ranks["ranks"]:
        want, got = res["moe_decode"][case]["unplaced"], res["moe_decode"][case]["placed"]
        decode_matches(got, want)
        assert len(got["picks"]) == len(want["picks"]) == 2 * moe_layers
        for g, w in zip(got["picks"], want["picks"]):
            np.testing.assert_array_equal(g, w)


def test_moe_decode_matches_jax_single_device(ranks):
    """DeepSeek-V2-Lite, unplaced and on the 2 x 2 mesh, against the JAX
    package's prefill and step on one device, on the same weights."""
    want = ranks["jax"]["moe_decode"]
    for side in ("unplaced", "placed"):
        got = ranks["ranks"][0]["moe_decode"][MOE_ARCH][side]
        np.testing.assert_array_equal(got["tok"], want["tok"])
        assert rel_err(got["last"], want["last"]) < RTOL, side
        assert rel_err(got["step"], want["step"]) < RTOL, side


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_expert_leaves_placed_by_the_rules(ranks, case):
    """Where the experts divide "model" (8 over 2) the stacked expert leaves
    cut their experts dim over it; where they do not (6 over 4) the
    experts are replicated and ``expert_ffn`` is cut 4 ways."""
    cfg = tconfigs.make_smoke(tconfigs.get_config(MOE_CASES[case][0])).replace(
        **MOE_CHANGES.get(case, {}))
    model_size = MOE_CASES[case][1][1]
    ffn_dim = {"wi": 3, "wg": 3, "wo": 2}  # (layers, experts, ...) expert_ffn's dim
    for res in ranks["ranks"]:
        rows = {row[0]: row for row in res["moe_layout"][case]}
        for w, f in ffn_dim.items():
            _, local, shape, spec, as_spec = rows[f"layers/b0/moe/{w}"]
            assert as_spec and shape[1] == cfg.n_experts
            if cfg.n_experts % model_size == 0:
                assert spec[1] == "model" and spec[f] is None
                assert local[1] == cfg.n_experts // model_size
            else:
                assert spec[1] is None and spec[f] == "model"
                assert local[1] == cfg.n_experts and local[f] == shape[f] // model_size


# ---------------------------------------------------------------------------
# the SSM, RG-LRU and encoder-decoder archs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STATE_ARCHS)
def test_state_decode_on_mesh_matches_unplaced(ranks, name):
    """Mamba2's SSM state and conv window, RecurrentGemma's RG-LRU state,
    conv window and attention ring, Whisper's self and cross caches: the
    placed prefill (with frames for Whisper) and step against the unplaced
    port by the decode criteria."""
    for res in ranks["ranks"]:
        decode_matches(res["state_decode"][name]["placed"], res["state_decode"][name]["unplaced"])


@pytest.mark.parametrize("name", STATE_ARCHS)
def test_state_decode_matches_jax_single_device(ranks, name):
    """The same prefill and step, unplaced and on the 2 x 2 mesh, against the
    JAX package's on one device, on the same weights."""
    want = ranks["jax"][name]["decode"]
    for side in ("unplaced", "placed"):
        got = ranks["ranks"][0]["state_decode"][name][side]
        np.testing.assert_array_equal(got["tok"], want["tok"])
        assert rel_err(got["last"], want["last"]) < RTOL, side
        assert rel_err(got["step"], want["step"]) < RTOL, side


def test_state_sites_cut_the_inner_widths(ranks):
    """On 2 x 2 the leaves that the SSM's and the RG-LRU's sites act on are
    cut over "model" (``ssm_inner`` of ``in_proj``, ``lru`` of ``w_rec``);
    the decode caches' conv windows, the SSM state and the remainder
    layer's RG-LRU state over "data" only, on their batch dim."""
    rows = {name: {row[0]: row[3] for row in ranks["ranks"][0]["state_layout"][name]}
            for name in STATE_ARCHS}
    mamba, rec = rows["mamba2-130m"], rows["recurrentgemma-9b"]
    assert mamba["layers/b0/ssm/in_proj"][-1] == "model"
    assert rec["layers/b0/rec/w_rec"][-1] == "model"
    for spec in (mamba["layers/b0/ssm/conv"], mamba["layers/b0/ssm/state"],
                 rec["layers/b0/rec/conv"], rec["layers/b1/rec/conv"]):
        assert spec[1] == "data" and "model" not in spec, spec
    assert rec["tail_0/rec/state"] == ("data", None)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def step_params_close(got, want, mu, lr: float) -> None:
    """``PERF.md`` §2's step rule: every element within 2 lr + PTOL, and
    within PTOL = 1e-6 + 1e-5 |p| where the reference's new first moment
    is well set (|mu| > 2 GRAD_RTOL max |mu| and > (1 - b1) 1e-4)."""
    for g, w, m in zip(got, want, mu):
        d, tol, m = np.abs(g - w), 1e-6 + 1e-5 * np.abs(w), np.abs(m)
        assert np.all(d <= 2.02 * lr + tol)
        well = m > max(2 * GRAD_RTOL * m.max(), 0.1 * 1e-4)
        assert np.all(d[well] <= tol[well])


def test_train_step_on_mesh_matches_unplaced(ranks):
    """The step placed by ``jit_train_step`` on the 2 x 2 mesh against the
    unplaced step from the same state: loss, the metrics returned whole,
    the params by the step rule, the moments, ``step`` and ``lr``."""
    for res in ranks["ranks"]:
        assert not any(res["train"]["metrics_placed"])
        step_matches(res["train"]["placed"], res["train"]["unplaced"])


def step_matches(got, want) -> None:
    """The loss within MESH_RTOL, ``grad_norm`` and the moments within
    GRAD_RTOL, the params by the step rule; ``step`` and ``lr`` exact."""
    wm, gm = want["metrics"], got["metrics"]
    assert rel_err(gm["loss"], wm["loss"]) < MESH_RTOL
    assert rel_err(gm["grad_norm"], wm["grad_norm"]) < GRAD_RTOL
    np.testing.assert_array_equal(gm["lr"], wm["lr"])
    (wp, (wmu, wnu, wstep, _)), (gp, (gmu, gnu, gstep, _)) = want["state"], got["state"]
    np.testing.assert_array_equal(gstep, wstep)
    for g, w in zip(leaves(gmu) + leaves(gnu), leaves(wmu) + leaves(wnu)):
        assert rel_err(g, w) < GRAD_RTOL
    step_params_close(leaves(gp), leaves(wp), leaves(wmu), float(wm["lr"]))


@pytest.mark.parametrize("case", list(REPAIR_CASES))
def test_repaired_site_on_mesh_matches_unplaced(ranks, case):
    """Each repaired site (``REPAIR_CASES``: the queries' view into KV
    groups, the microbatch split, the SSD's chunk and head views, forward
    and backward) on the mesh whose cut it failed on before the repair:
    the decode and the step placed against unplaced by their criteria."""
    for res in ranks["ranks"]:
        got = res["repair"][case]
        assert set(got) == set(REPAIR_CASES[case][3])
        if "decode" in got:
            decode_matches(got["decode"]["placed"], got["decode"]["unplaced"])
        if "step" in got:
            step_matches(got["step"]["placed"], got["step"]["unplaced"])


@pytest.mark.parametrize("name", PINNED_ARCHS)
def test_pinned_arch_on_mesh_matches_unplaced(ranks, name):
    """Qwen2-VL-7B (M-RoPE) and StarCoder2-15B decode on 2 x 2 by the decode
    criteria; Qwen2-VL's step, M-RoPE's backward among it, by the step's."""
    for res in ranks["ranks"]:
        got = res["pinned"][name]
        decode_matches(got["decode"]["placed"], got["decode"]["unplaced"])
        assert ("step" in got) == (name == "qwen2-vl-7b")
        if "step" in got:
            step_matches(got["step"]["placed"], got["step"]["unplaced"])


def test_train_step_matches_jax_single_device(ranks):
    want = ranks["jax"]["train"]
    for side in ("unplaced", "placed"):
        got = ranks["ranks"][0]["train"][side]["metrics"]
        assert rel_err(got["loss"], want["loss"]) < RTOL, side
        assert rel_err(got["grad_norm"], want["grad_norm"]) < GRAD_RTOL, side


def test_train_state_placed_by_state_pspecs(ranks):
    """The placed step's state follows ``state_pspecs``; with ``donate`` the
    new state lands in the passed placed state's shards, equal to the
    step without donation."""
    mesh = tshd.make_mesh((2, 2), ("data", "model"), "cpu")
    for res in ranks["ranks"]:
        assert res["donated"]
        assert res["train_layout"]
        for path, local, shape, spec, as_spec in res["train_layout"]:
            assert as_spec, path
            cuts = tshd.shards(mesh, spec) + (1,) * (len(shape) - len(spec))
            assert local == tuple(n // c for n, c in zip(shape, cuts)), (path, spec)


def test_moe_train_step_on_mesh_matches_unplaced(ranks):
    """DeepSeek-V2-Lite's step placed by ``jit_train_step`` on 2 x 2 (its
    experts cut over "model") against the unplaced step: the step's
    criteria, the aux loss of ``loss_fn`` (the whole batch's: its means
    reduce over every rank's rows) within MESH_RTOL, and the new state
    placed by ``state_pspecs``."""
    mesh = tshd.make_mesh((2, 2), ("data", "model"), "cpu")
    for res in ranks["ranks"]:
        want, got = res["moe_train"]["unplaced"], res["moe_train"]["placed"]
        step_matches(got, want)
        assert want["aux"] > 0 and rel_err(got["aux"], want["aux"]) < MESH_RTOL
        for path, local, shape, spec, as_spec in res["moe_train_layout"]:
            assert as_spec, path
            cuts = tshd.shards(mesh, spec) + (1,) * (len(shape) - len(spec))
            assert local == tuple(n // c for n, c in zip(shape, cuts)), (path, spec)


def test_moe_train_step_matches_jax_single_device(ranks):
    """The same step, and ``loss_fn``'s aux, unplaced and placed, against the
    JAX package's single-device step on the same weights."""
    want = ranks["jax"]["moe_train"]
    for side in ("unplaced", "placed"):
        got = ranks["ranks"][0]["moe_train"][side]
        assert rel_err(got["metrics"]["loss"], want["loss"]) < RTOL, side
        assert rel_err(got["aux"], want["aux"]) < RTOL, side
        assert rel_err(got["metrics"]["grad_norm"], want["grad_norm"]) < GRAD_RTOL, side


@pytest.mark.parametrize("name", STATE_ARCHS)
def test_state_train_step_on_mesh_matches_unplaced(ranks, name):
    """Each arch's step placed by ``jit_train_step`` on 2 x 2 (Whisper's
    batch with its frames) against the unplaced step by the step's
    criteria, the new state placed by ``state_pspecs``."""
    mesh = tshd.make_mesh((2, 2), ("data", "model"), "cpu")
    for res in ranks["ranks"]:
        step_matches(res["state_train"][name]["placed"], res["state_train"][name]["unplaced"])
        for path, local, shape, spec, as_spec in res["state_train_layout"][name]:
            assert as_spec, path
            cuts = tshd.shards(mesh, spec) + (1,) * (len(shape) - len(spec))
            assert local == tuple(n // c for n, c in zip(shape, cuts)), (path, spec)


@pytest.mark.parametrize("name", STATE_ARCHS)
def test_state_train_step_matches_jax_single_device(ranks, name):
    want = ranks["jax"][name]["train"]
    for side in ("unplaced", "placed"):
        got = ranks["ranks"][0]["state_train"][name][side]["metrics"]
        assert rel_err(got["loss"], want["loss"]) < RTOL, side
        assert rel_err(got["grad_norm"], want["grad_norm"]) < GRAD_RTOL, side


def test_compression_scale_is_the_whole_leafs(ranks):
    """int8 error feedback on a leaf cut over both mesh axes: each shard is
    quantized with the whole leaf's amax, so the values equal the
    unplaced compression's exactly."""
    for res in ranks["ranks"]:
        for g, w in zip(leaves(res["compress"]["placed"]), leaves(res["compress"]["unplaced"])):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# checkpoint: save from 2 x 2, restore onto 1 x 4
# ---------------------------------------------------------------------------


def test_elastic_restore_bit_for_bit(ranks):
    """The gemma-7b state saved from the 2 x 2 mesh (in the foreground, and
    again on rank 0's writer thread) restores onto 1 x 4 bit for bit,
    each leaf placed by its 1 x 4 spec."""
    mesh2 = tshd.make_mesh((1, 4), ("data", "model"), "cpu")
    for res in ranks["ranks"]:
        assert res["restore_equal"] == [True, True]  # the foreground save, the background one
        assert res["latest"] == 8
        for path, local, shape, spec, as_spec in res["restore_layout"]:
            assert as_spec, path
            cuts = tshd.shards(mesh2, spec) + (1,) * (len(shape) - len(spec))
            assert local == tuple(n // c for n, c in zip(shape, cuts)), (path, spec)


def test_moe_elastic_restore_bit_for_bit(ranks):
    """A DeepSeek-V2-Lite state saved from 2 x 2 (experts cut over "model"
    2) restores onto 1 x 4 (experts cut 4 ways) bit for bit, each leaf
    placed by its 1 x 4 spec."""
    mesh2 = tshd.make_mesh((1, 4), ("data", "model"), "cpu")
    for res in ranks["ranks"]:
        assert res["moe_restore_equal"]
        rows = {row[0]: row for row in res["moe_restore_layout"]}
        assert rows["params/layers/b0/moe/wi"][1][1] == 2  # 8 experts over 4
        for path, local, shape, spec, as_spec in res["moe_restore_layout"]:
            assert as_spec, path
            cuts = tshd.shards(mesh2, spec) + (1,) * (len(shape) - len(spec))
            assert local == tuple(n // c for n, c in zip(shape, cuts)), (path, spec)


def test_recurrent_elastic_restore_bit_for_bit(ranks):
    """A RecurrentGemma state saved from 2 x 2 (the RG-LRU width cut over
    "model" 2) restores onto 1 x 4 (cut 4 ways) bit for bit, each leaf
    placed by its 1 x 4 spec."""
    mesh2 = tshd.make_mesh((1, 4), ("data", "model"), "cpu")
    for res in ranks["ranks"]:
        assert res["rec_restore_equal"]
        rows = {row[0]: row for row in res["rec_restore_layout"]}
        local, shape = rows["params/layers/b0/rec/w_rec"][1:3]
        assert local[-1] * 4 == shape[-1]
        for path, local, shape, spec, as_spec in res["rec_restore_layout"]:
            assert as_spec, path
            cuts = tshd.shards(mesh2, spec) + (1,) * (len(shape) - len(spec))
            assert local == tuple(n // c for n, c in zip(shape, cuts)), (path, spec)


def test_placed_save_writes_the_plain_bytes(ranks):
    """Rank 0 writes the gathered state: the same manifest (shapes, dtypes,
    digests) as a plain save of the state, and the same arrays."""
    import json

    d = ranks["dir"]
    read = lambda name: json.loads((d / name / "step_00000007" / "manifest.json").read_text())
    mesh_m, plain_m = read("ckpt_mesh"), read("ckpt_plain")
    assert mesh_m["leaves"] == plain_m["leaves"] and mesh_m["treedef"] == plain_m["treedef"]
    assert not list((d / "ckpt_mesh").glob(".tmp_*"))


# ---------------------------------------------------------------------------
# placements, refusals, and no change without a DeviceMesh
# ---------------------------------------------------------------------------


def test_placements_against_spec_every_leaf():
    """Every param, cache and state leaf of the eight configs (the MoE ones'
    expert leaves and MLA latents, the SSM and RG-LRU states and conv
    windows, Whisper's encoder and cross caches among them): one
    placement a mesh axis, ``Shard(d)`` where the spec names that axis at
    dim ``d``, else ``Replicate()``; on the 2 x 2 mesh and the multi-pod
    mesh, whose ("pod", "data") tuples cut one dim by two axes."""
    from torch.distributed.tensor import Replicate, Shard

    def want(mesh, spec):
        out = []
        for name in mesh.axis_names:
            dims = [d for d, p in enumerate(spec)
                    if p is not None and name in ((p,) if isinstance(p, str) else p)]
            assert len(dims) <= 1
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    ocfg = toptim.OptConfig(compress_grads=True)
    tuples = 0
    for mesh in (tshd.make_mesh((2, 2), ("data", "model"), "cpu"),
                 make_production_mesh(multi_pod=True)):
        for name in (DECODE_ARCH, TRAIN_ARCH, RESTORE_ARCH, MOE_ARCH, "grok-1-314b") + STATE_ARCHS:
            cfg = tconfigs.make_smoke(tconfigs.get_config(name))
            for decode in (False, True):
                rules = tshd.ShardingRules.for_config(mesh, cfg, decode=decode)
                cache = tmodel.init_cache(cfg, 8, 64, device="meta")
                specs = [s for tree in (tmodel.partition_pspecs(cfg, rules),
                                        tserve.cache_pspecs(cfg, rules, cache),
                                        tts.state_pspecs(cfg, ocfg, rules))
                         for s in tschema.tree_leaves(tree, is_leaf=lambda s: type(s) is tuple)]
                for spec in specs:
                    assert tshd.placements(mesh, spec) == want(mesh, spec), spec
                    tuples += any(isinstance(p, tuple) for p in spec)
    assert tuples > 0
    rules = tshd.ShardingRules.for_config(make_production_mesh(multi_pod=True))
    assert rules.placements(("batch", None), (64, 8)) == (Shard(0), Shard(0), Replicate())


def test_tuple_spec_both_ways(ranks):
    """A dim cut by ("data", "model") holds on each rank the block JAX
    gives it, data major: rows 2 r, 2 r + 1 of rank r.  The other order,
    ("model", "data"), which DTensor's ``Shard`` cannot lay out, raises."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r, res in enumerate(ranks["ranks"]):
        np.testing.assert_array_equal(res["tuple_local"], x[2 * r : 2 * r + 2])
        assert "major to minor" in res["tuple_reversed"]
    mesh = make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="major to minor"):
        tshd.placements(mesh, (("data", "pod"),))


def test_check_devices_refuses_a_mesh_unlike_the_world(ranks):
    for res in ranks["ranks"]:
        assert res["mesh"] == (True, "cpu", {"data": 2, "model": 2})
        for sizes, msg in res["refused"].items():
            assert msg is not None and "devices" in msg, sizes
        assert res["world_mesh_ok"] is None


def test_no_device_mesh_no_change(ranks):
    """Without a DeviceMesh ``constrain`` returns its input, the same object,
    under the rules of a description; with a process group up, the dry
    run's meshes stay descriptions and its cell equals this process's."""
    x = torch.ones(2, 3, 4)
    rules = tshd.ShardingRules.for_config(tshd.make_mesh((2, 2), ("data", "model"), "cpu"))
    with tshd.use_rules(rules):
        assert tshd.constrain(x, "batch", "seq", "embed") is x
    with pytest.raises(ValueError, match="DeviceMesh"):
        tshd.place({"w": x}, {"w": (None, None, None)}, rules.mesh)
    for res in ranks["ranks"]:
        assert res["descriptions"] == (None, None)
    from repro_torch.launch import dryrun

    cell = dryrun.run_cell(dryrun.Cell("qwen3-8b", "decode_32k", ("1x1",)))[0]
    assert ranks["ranks"][0]["dry_cell"] == {k: v for k, v in cell.items() if k != "seconds"}


# ---------------------------------------------------------------------------
# the reference's constrain sites
# ---------------------------------------------------------------------------


def _constrain_calls(modules, run) -> list:
    """The logical axes of every ``constrain`` call while ``run`` runs, with
    each module's ``constrain`` replaced by a recorder."""
    calls, saved = [], [m.constrain for m in modules]

    def record(x, *axes):
        calls.append(tuple(axes))
        return x

    for m in modules:
        m.constrain = record
    try:
        run()
    finally:
        for m, f in zip(modules, saved):
            m.constrain = f
    return sorted(calls, key=repr)


# the dense case keeps its ids; the MoE cases: DeepSeek-V2-Lite at 2 layers
# (the dense first layer and one MoE unit), Grok-1 at 1; Mamba2 at 1,
# RecurrentGemma at 3 (one unit of its pattern), Whisper at 1 with one
# encoder layer
SITE_CASES = [pytest.param(DECODE_ARCH, 1, entry, id=entry)
              for entry in ("forward", "loss_fn", "decode_step")] + [
    pytest.param(name, n, entry, id=f"{name}-{entry}")
    for name, n in ((MOE_ARCH, 2), ("grok-1-314b", 1), ("mamba2-130m", 1),
                    ("recurrentgemma-9b", 3), ("whisper-large-v3", 1))
    for entry in ("forward", "loss_fn", "decode_step")]
SITE_COUNTS = {
    DECODE_ARCH: {"forward": 9, "loss_fn": 8, "decode_step": 7},
    MOE_ARCH: {"forward": 12, "loss_fn": 11, "decode_step": 10},
    "grok-1-314b": {"forward": 13, "loss_fn": 12, "decode_step": 11},
    "mamba2-130m": {"forward": 3, "loss_fn": 2, "decode_step": 1},
    "recurrentgemma-9b": {"forward": 13, "loss_fn": 12, "decode_step": 11},
    "whisper-large-v3": {"forward": 16, "loss_fn": 15, "decode_step": 9},
}


@pytest.mark.parametrize("name, n_layers, entry", SITE_CASES)
def test_constrain_sites_match_the_reference(name, n_layers, entry):
    """The model's constrain sites, counted with their axes: a model of
    ``n_layers`` layers (the reference's scan traces its unit once; one
    encoder layer for Whisper) runs through the same calls in both
    packages, ``moe_ffn``'s five sites included and no site in the shared
    experts, the SSM's ``ssm_inner`` and the RG-LRU's ``lru`` sites too."""
    small = {"n_layers": n_layers}
    if name == "whisper-large-v3":
        small["encoder_layers"] = 1
    jcfg = jconfigs.make_smoke(jconfigs.get_config(name)).replace(**small)
    tcfg = tconfigs.make_smoke(tconfigs.get_config(name)).replace(**small)
    params = tmodel.init(tcfg, 0, "cpu")
    jparams = jax.tree.map(jnp.asarray, tmodel.to_numpy(params))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(tokens)}
    if tcfg.is_encoder_decoder:
        tb["frames"] = torch.from_numpy(
            rng.normal(size=(2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32))
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    if entry == "decode_step":
        tcache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
        jcache = jmodel.init_cache(jcfg, 2, 16)
        trun = lambda: tmodel.decode_step(params, tcfg, tcache, tb["tokens"][:, :1])
        jrun = lambda: jmodel.decode_step(jparams, jcfg, jcache, jb["tokens"][:, :1])
    else:
        trun = lambda: getattr(tmodel, entry)(params, tcfg, tb)
        jrun = lambda: getattr(jmodel, entry)(jparams, jcfg, jb)
    got = _constrain_calls((tattention, tlayers, tmoe, trglru, tssm, ttransformer, tmodel), trun)
    # the reference's sites are calls at trace time: a jaxpr records them
    # all, without running the model op by op
    want = _constrain_calls((jattention, jlayers, jmoe, jrglru, jssm, jtransformer, jmodel),
                            lambda: jax.make_jaxpr(jrun)())
    assert got == want
    assert len(got) == SITE_COUNTS[name][entry]
    if tcfg.is_moe:
        for axes in (("batch", None, "embed"), ("batch", "experts", None, "embed"),
                     ("batch", "experts", None, "expert_ffn")):
            assert axes in got
    kinds = set(ttransformer.layer_kinds(tcfg))
    assert (("batch", None, "ssm_inner") in got) == ("ssm" in kinds)
    assert (("batch", None, "lru") in got) == ("rec" in kinds)
