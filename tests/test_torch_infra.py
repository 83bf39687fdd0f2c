"""The port's sharding rules, checkpointing and fault tolerance
(``repro_torch.sharding``, ``repro_torch.train.checkpoint``,
``repro_torch.train.fault_tolerance``) against the JAX package on the CPU.

* ``ShardingRules.for_config`` on four mesh descriptions (``(1, 4)``,
  ``(2, 4)``, ``(1, 16)`` over ("data", "model") and ``(2, 2, 4)`` over
  ("pod", "data", "model"); the JAX side on ``jax.sharding.AbstractMesh``,
  which needs no devices), all ten full configs, ``decode`` and
  ``seq_shard`` both ways: the mappings equal, and ``partition_pspecs``,
  ``state_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` equal leaf for
  leaf as tuples.
* The reference's ``TestCheckpoint`` and ``TestFaultTolerance`` cases on
  the port; checkpoints written by either package restore in the port
  (float32, and the reverse) with equal leaves; a bfloat16 checkpoint
  round trip (the JAX package's own restore cannot read one); the
  elastic restore onto a ``(1, 4)`` mesh description.

Everything here is exact: specs, leaves, counters.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro import configs as jconfigs
from repro import sharding as jshd
from repro.models import model as jmodel
from repro.serve import serve_step as jserve
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import configs as tconfigs
from repro_torch import sharding as tshd
from repro_torch.models import model as tmodel
from repro_torch.models import schema as tschema
from repro_torch.serve import serve_step as tserve
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import (
    ClusterMonitor,
    FTConfig,
    HostState,
    TrainSupervisor,
    plan_rescale,
)

MESHES = {
    "1x4": ((1, 4), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x16": ((1, 16), ("data", "model")),
    "2x2x4": ((2, 2, 4), ("pod", "data", "model")),
}


def as_tuples(tree):
    """A JAX spec tree (dicts, NamedTuples, PartitionSpecs) with each spec
    as a plain tuple and each NamedTuple as a tuple."""
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(as_tuples(t) for t in tree)
    return tree


def plain(tree):
    """A port spec tree with each NamedTuple as a tuple."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(plain(t) for t in tree)
    return tree


# ---------------------------------------------------------------------------
# Sharding rules and spec trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", tconfigs.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharding_rules_match_jax(mesh, name):
    sizes, names = MESHES[mesh]
    jmesh = AbstractMesh(sizes, names)
    tmesh = tshd.make_mesh(sizes, names, device="cpu")
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    jcache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, 8, 64))
    tcache = tmodel.init_cache(tcfg, 8, 64, device="meta")
    jbatch = {"tokens": jnp.zeros((8, 64), jnp.int32), "targets": jnp.zeros((8, 64), jnp.int32),
              "frames": jnp.zeros((8, 4, 16))}
    tbatch = {k: torch.zeros(v.shape, device="meta") for k, v in jbatch.items()}
    for seq_shard in (True, False):
        for decode in (False, True):
            jr = jshd.ShardingRules.for_config(jmesh, jcfg, seq_shard=seq_shard, decode=decode)
            tr = tshd.ShardingRules.for_config(tmesh, tcfg, seq_shard=seq_shard, decode=decode)
            assert tr.mapping == jr.mapping
            assert tmodel.partition_pspecs(tcfg, tr) == as_tuples(jmodel.partition_pspecs(jcfg, jr))
            assert tserve.cache_pspecs(tcfg, tr, tcache) == as_tuples(
                jserve.cache_pspecs(jcfg, jr, jcache))
            assert tts.batch_pspecs(tcfg, tr, tbatch) == as_tuples(
                jts.batch_pspecs(jcfg, jr, jbatch))
            for compress in (False, True):
                jo = joptim.OptConfig(compress_grads=compress)
                to = toptim.OptConfig(compress_grads=compress)
                assert plain(tts.state_pspecs(tcfg, to, tr)) == as_tuples(
                    jts.state_pspecs(jcfg, jo, jr))
    # no config: the bare mapping
    assert tshd.ShardingRules.for_config(tmesh).mapping == \
        jshd.ShardingRules.for_config(jmesh).mapping


def test_spec_shape_fallback_and_reused_axes():
    """A mapping that does not divide its dim falls back to replicated; a
    mesh axis taken by an earlier dim is not used again."""
    rules = tshd.ShardingRules.for_config(tshd.make_mesh((2, 4), ("data", "model"), "cpu"))
    jrules = jshd.ShardingRules.for_config(AbstractMesh((2, 4), ("data", "model")))
    for axes, shape in ((("batch", "seq", "vocab"), (8, 64, 6)),
                        (("batch", "seq", "vocab"), (3, 64, 8)),
                        (("heads", "ffn"), (8, 12)), (("embed", "batch"), (8, 8)),
                        (("layers", None, "experts"), (4, 2, 8))):
        assert rules.spec(axes, shape) == tuple(jrules.spec(axes, shape))
        assert rules.spec(axes) == tuple(jrules.spec(axes))
    assert rules.sharding(("batch",), (8,)) == (rules.mesh, ("data",))
    assert tshd.shards(rules.mesh, (("data", "model"), None, "model")) == (8, 1, 4)


def test_constrain_checks_rank_under_rules():
    x = torch.ones(2, 3, 4)
    assert tshd.constrain(x, "batch") is x  # no rules: no check
    rules = tshd.ShardingRules.for_config(tshd.make_mesh((1, 1), ("data", "model"), "cpu"))
    with tshd.use_rules(rules):
        assert tshd.active_rules() is rules
        assert tshd.constrain(x, "batch", "seq", "embed") is x
        with pytest.raises(ValueError, match="rank mismatch"):
            tshd.constrain(x, "batch", "seq")
        with tshd.use_rules(None):
            assert tshd.constrain(x, "batch") is x
    assert tshd.active_rules() is None


def test_mesh_device_count():
    """A mesh of one device builds a step on the CPU; a larger one raises,
    as JAX refuses a mesh larger than its devices."""
    assert tshd.make_mesh((1, 1), ("data", "model"), "cpu").size == 1
    with pytest.raises(ValueError, match="rank"):
        tshd.make_mesh((1, 2), ("data",), "cpu")
    cfg = tconfigs.make_smoke(tconfigs.get_config("qwen3-8b"))
    with pytest.raises(ValueError, match="devices"):
        tts.jit_train_step(cfg, toptim.OptConfig(),
                           tshd.make_mesh((2, 4), ("data", "model"), "cpu"))


def test_jit_train_step_matches_make_train_step():
    """The step under a one-device mesh's rules (every ``constrain`` rank
    checked) equals the plain step bit for bit; ``donate`` writes the new
    state into the passed tensors."""
    cfg = tconfigs.make_smoke(tconfigs.get_config("qwen3-8b")).replace(n_layers=2)
    ocfg = toptim.OptConfig()
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32))
             for k in ("tokens", "targets")}
    want, m0 = tts.make_train_step(cfg, ocfg)(tts.init_state(cfg, ocfg, 0, "cpu"), batch)
    mesh = tshd.make_mesh((1, 1), ("data", "model"), "cpu")
    for donate in (False, True):
        state = tts.init_state(cfg, ocfg, 0, "cpu")
        step, rules = tts.jit_train_step(cfg, ocfg, mesh, donate=donate)
        got, m1 = step(state, batch)
        assert (got is state) == donate
        assert rules.mapping == tshd.ShardingRules.for_config(mesh, cfg).mapping
        assert torch.equal(m1["loss"], m0["loss"])
        for a, b in zip(tschema.tree_leaves(got), tschema.tree_leaves(want)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ports of tests/test_infra.py::TestCheckpoint
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
        state = {"a": torch.arange(10, dtype=torch.float32), "b": {"c": torch.ones((3, 3))}}
        mgr.save(5, state)
        assert mgr.latest_step() == 5
        like = tschema.tree_map(lambda t: torch.empty(t.shape, device="meta"), state)
        got = mgr.restore(5, like, device="cpu")
        np.testing.assert_array_equal(got["a"].numpy(), np.arange(10, dtype=np.float32))
        assert torch.equal(got["b"]["c"], state["b"]["c"])

    def test_gc_keeps_last_k(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
        state = {"x": torch.zeros(4)}
        for s in (1, 2, 3, 4):
            mgr.save(s, state)
        steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
        assert steps == ["step_00000003", "step_00000004"]

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.arange(1000)}, background=True)
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_corruption_detected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        state = {"x": torch.arange(16, dtype=torch.int32)}
        mgr.save(1, state)
        p = tmp_path / "step_00000001" / "shard_0.npz"
        data = dict(np.load(p))
        data["leaf_0"] = data["leaf_0"] + 1
        np.savez(p, **data)
        with pytest.raises(IOError):
            mgr.restore(1, state, device="cpu")

    def test_structure_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.zeros(4)})
        with pytest.raises(ValueError):
            mgr.restore(1, {"x": torch.zeros(4), "y": torch.zeros(2)}, device="cpu")


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------


def jax_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(jax_numpy(t) for t in tree))
    return None if tree is None else np.asarray(tree)


def train_states(name="gemma-7b", compress=False, steps=1):
    """The JAX package's state after ``steps`` steps (float32 smoke) and
    the port's copy of it, so every leaf is non-trivial."""
    cfg = jconfigs.make_smoke(jconfigs.get_config(name))
    ocfg = joptim.OptConfig(compress_grads=compress)
    state = jts.init_state(cfg, ocfg, 0)
    rng = np.random.default_rng(2)
    step = jax.jit(jts.make_train_step(cfg, ocfg))
    for _ in range(steps):
        batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)), jnp.int32)
                 for k in ("tokens", "targets")}
        state, _ = step(state, batch)
    tcfg = tconfigs.make_smoke(tconfigs.get_config(name))
    tocfg = toptim.OptConfig(compress_grads=compress)
    return state, tts.from_numpy(tcfg, tocfg, jax_numpy(state), device="cpu"), tcfg, tocfg


def assert_leaves_equal(port_state, jax_state):
    got, want = tschema.tree_leaves(port_state), jax.tree.leaves(jax_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_across_packages(tmp_path, writer):
    """A float32 train state written by one package restores in the other
    (the port restores, or writes for the JAX package's restore) with
    every leaf equal; the manifests list the same shapes, dtypes and
    digests."""
    jstate, tstate, tcfg, tocfg = train_states()
    JCheckpointManager(str(tmp_path / "jax")).save(3, jstate)
    CheckpointManager(str(tmp_path / "port")).save(3, tstate)
    manifests = [json.load(open(tmp_path / d / "step_00000003" / "manifest.json"))["leaves"]
                 for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    src = str(tmp_path / writer)
    if writer == "jax":
        got = CheckpointManager(src).restore(3, tts.abstract_state(tcfg, tocfg), device="cpu")
        assert_leaves_equal(got, jstate)
        assert got.opt.step.dtype == torch.int32
    else:
        got = JCheckpointManager(src).restore(3, jax.eval_shape(lambda: jstate))
        assert_leaves_equal(tstate, got)


def test_bf16_checkpoint_round_trip(tmp_path):
    """A bfloat16 state (bf16 params and error-feedback residual) saved and
    restored by the port, bit for bit: the leaves are written as the JAX
    package writes them (``|V2`` bits, ``"bfloat16"`` in the manifest), and
    the manifest's dtype reads them back.  The JAX package's own restore
    raises on such a leaf (``jax.numpy.asarray`` of ``|V2``), so its side
    is not called."""
    cfg = tconfigs.make_smoke(tconfigs.get_config("mamba2-130m")).replace(
        param_dtype="bfloat16", act_dtype="bfloat16")
    ocfg = toptim.OptConfig(compress_grads=True)
    state = tts.init_state(cfg, ocfg, 0, "cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
             for k in ("tokens", "targets")}
    state, _ = tts.make_train_step(cfg, ocfg)(state, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    d = tmp_path / "step_00000001"
    manifest = json.load(open(d / "manifest.json"))
    flat = tschema.tree_leaves(state)
    with np.load(d / "shard_0.npz") as data:
        for i, (meta, leaf) in enumerate(zip(manifest["leaves"], flat)):
            if leaf.dtype == torch.bfloat16:
                assert meta["dtype"] == "bfloat16" and data[f"leaf_{i}"].dtype.str == "|V2"
    # the params and the residual
    assert sum(t.dtype == torch.bfloat16 for t in flat) == 2 * len(tschema.tree_leaves(state.params))
    got = mgr.restore(1, tts.abstract_state(cfg, ocfg), device="cpu")
    for a, b in zip(tschema.tree_leaves(got), flat):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_elastic_restore_to_mesh(tmp_path):
    """tests/test_distributed.py's elastic restore on the port: a state
    saved whole restores with the specs of a (1, 4) mesh description, each
    spec dividing its leaf, the values equal; a spec that does not divide
    its leaf raises."""
    cfg = tconfigs.make_smoke(tconfigs.get_config("gemma-7b"))
    ocfg = toptim.OptConfig()
    state = tts.init_state(cfg, ocfg, 0, "cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state)
    mesh = tshd.make_mesh((1, 4), ("data", "model"), "cpu")
    rules = tshd.ShardingRules.for_config(mesh, cfg)
    sspec = tts.state_pspecs(cfg, ocfg, rules)
    assert any("model" in s for s in tschema.tree_leaves(
        sspec, is_leaf=lambda x: type(x) is tuple))
    got = mgr.restore(7, tts.abstract_state(cfg, ocfg), shardings=(mesh, sspec))
    for a, b in zip(tschema.tree_leaves(got), tschema.tree_leaves(state)):
        assert a.device == mesh.device and torch.equal(a, b)
    bad = sspec._replace(params=dict(sspec.params, tok_embed=(None, ("data", "model"), None)))
    with pytest.raises(ValueError, match="spec"):
        mgr.restore(7, state, shardings=(mesh, bad))
    odd = dict(sspec.params, final_norm={"scale": ("model",)})
    wide = tshd.make_mesh((1, 3), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="divide"):
        mgr.restore(7, state, shardings=(wide, sspec._replace(params=odd)))


# ---------------------------------------------------------------------------
# ports of tests/test_infra.py::TestFaultTolerance
# ---------------------------------------------------------------------------


class TestFaultTolerance:
    def _fake_clock(self):
        t = [0.0]
        return t, lambda: t[0]

    def test_heartbeat_death_and_rescale(self):
        t, clock = self._fake_clock()
        cfg = FTConfig(heartbeat_timeout_s=30)
        mon = ClusterMonitor([f"h{i}" for i in range(8)], cfg, clock=clock)
        t[0] = 10.0
        for h in ("h0", "h1", "h2", "h3", "h4", "h5"):
            mon.heartbeat(h)
        t[0] = 35.0  # h6, h7 (last beat t=0) missed the 30s timeout
        assert set(mon.sweep()) == {"h6", "h7"}
        plan = plan_rescale(mon, current_dp=4, hosts_per_replica=2, cfg=cfg)
        assert plan.action == "restore_rescale"
        assert plan.data_parallel == 3  # 6 healthy / 2 per replica

    def test_halt_below_min(self):
        t, clock = self._fake_clock()
        cfg = FTConfig(min_data_parallel=3)
        mon = ClusterMonitor(["h0", "h1", "h2", "h3"], cfg, clock=clock)
        t[0] = 100.0
        mon.sweep()  # everyone dead
        assert plan_rescale(mon, current_dp=4, hosts_per_replica=1, cfg=cfg).action == "halt"

    def test_straggler_suspects(self):
        t, clock = self._fake_clock()
        cfg = FTConfig(step_deadline_s=10, suspect_strikes=2)
        mon = ClusterMonitor(["h0", "h1"], cfg, clock=clock)
        mon.step_completed(50.0, slow_hosts=["h1"])
        assert mon.state["h1"] is HostState.HEALTHY
        mon.step_completed(50.0, slow_hosts=["h1"])
        assert mon.state["h1"] is HostState.SUSPECT
        mon.heartbeat("h1")
        assert mon.state["h1"] is HostState.HEALTHY

    def test_supervisor_restores_on_failure(self):
        t, clock = self._fake_clock()
        cfg = FTConfig()
        mon = ClusterMonitor(["h0", "h1", "h2", "h3"], cfg, clock=clock)
        restored = []
        sup = TrainSupervisor(mon, cfg, hosts_per_replica=1, current_dp=4,
                              on_restore=lambda dp: restored.append(dp))
        assert sup.run_step(lambda: {"loss": 1.0}) is not None
        t[0] = 100.0
        mon.heartbeat("h0"); mon.heartbeat("h1"); mon.heartbeat("h2")
        out = sup.run_step(lambda: {"loss": 1.0})
        assert out is None and restored == [3] and sup.restarts == 1
