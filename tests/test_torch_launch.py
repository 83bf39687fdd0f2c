"""The port's launch tools (``launch/shapes``, ``mesh``, ``roofline``,
``dryrun``) against the JAX package, on the CPU.

* ``SHAPES``, ``cell_applicable`` for all ten archs and four shapes, and
  every leaf of ``input_specs`` (shape and dtype, the decode caches
  included) equal to the JAX package's ``ShapeDtypeStruct``s.
* ``model_flops_estimate`` equal for every cell; the reference's
  ``TestRoofline`` with the H100's rates.
* Per-device argument bytes on the 16 x 16 and 2 x 16 x 16 meshes equal
  to the same sum over the JAX package's ``jax.eval_shape`` leaves and
  its ``partition_pspecs`` on ``AbstractMesh`` meshes.
* The dry run's flops, which it carries from runs cut to one and two
  units (and, for a long prefill, to shorter lengths), equal to a plain
  full-depth, full-length meta run's: every smoke config at each shape
  kind, the length fit at a length past its check, and a full-width
  decode cell, whose counted flops lie within ``FLOPS_FACTOR`` of
  ``model_flops_estimate`` (fixed before the first run; ``PERF.md`` §2).
* The least times ``chip_smoke.py`` prints (``prefill_bound_ms``,
  ``decode_bound_ms``, ``train_bound_ms``, now in ``launch/roofline.py``)
  pinned, to the last digit, at one config of each of phases 17–20, and
  the dry run's memory term the same bytes (``roofline.step_bytes``).

Everything but the flops factor and the carried operations is exact.
"""

from __future__ import annotations

import json
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro import configs as jconfigs
from repro import sharding as jshd
from repro.launch import roofline as jrf
from repro.launch import shapes as jshapes
from repro.models import model as jmodel
from repro.serve import serve_step as jserve
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import ARCHS, get_config, make_smoke
from repro_torch.launch import dryrun, roofline as rf, shapes
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.train import optimizer as toptim

FLOPS_FACTOR = 1.25  # counted decode flops within this factor of model_flops_estimate


def _leaves(tree, prefix=()):
    """{path: (shape, dtype name)} of a nested dict of tensors or structs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def test_shapes_match_jax():
    assert set(shapes.SHAPES) == set(jshapes.SHAPES)
    for name, spec in shapes.SHAPES.items():
        j = jshapes.SHAPES[name]
        assert (spec.name, spec.kind, spec.seq, spec.batch) == (j.name, j.kind, j.seq, j.batch)
    assert shapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_inputs_match_jax(arch):
    """``cell_applicable``, ``input_specs`` and ``model_flops_estimate`` at
    every shape."""
    tcfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for name, spec in shapes.SHAPES.items():
        assert shapes.cell_applicable(tcfg, name) == jshapes.cell_applicable(jcfg, name)
        assert rf.model_flops_estimate(tcfg, spec.kind, spec.batch, spec.seq) == \
            jrf.model_flops_estimate(jcfg, spec.kind, spec.batch, spec.seq)
        got, want = shapes.input_specs(tcfg, name), jshapes.input_specs(jcfg, name)
        assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(
            _leaves(got)) if isinstance(t, torch.Tensor))
        assert _leaves(got) == _leaves(want), name


def test_roofline_terms_and_bound():
    r = rf.Roofline(
        flops=989e12, bytes_accessed=3.35e12 * 2, coll_bytes=450e9 / 2, chips=4,
        model_flops=4 * 989e12 * 0.5,
    )
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(0.5)
    assert r.bound == "memory"
    assert r.mfu == pytest.approx(0.25)
    k = rf.kernel_roofline(3.35e9)
    assert (k.t_memory, k.t_compute, k.chips, k.bound) == (1e-3, 0.0, 1, "memory")


def test_roofline_model_flops_train_vs_decode():
    cfg = get_config("qwen3-8b")
    tr = rf.model_flops_estimate(cfg, "train", 256, 4096)
    de = rf.model_flops_estimate(cfg, "decode", 128, 32768)
    assert tr > 6 * cfg.param_count() * 256 * 4096 * 0.99
    assert de < tr / 1000


def test_meshes_are_descriptions():
    m = make_production_mesh()
    assert (m.shape, m.device.type, m.size) == ({"data": 16, "model": 16}, "meta", 256)
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert make_debug_mesh(1, 1).shape == {"data": 1, "model": 1}
    assert make_debug_mesh().size == 4
    # no process group here: each mesh is a description, with no DeviceMesh
    assert all(m.device_mesh is None for m in (
        make_production_mesh(), make_production_mesh(multi_pod=True), make_debug_mesh(),
        dryrun.one_card()))


def _jax_shard_bytes(jmesh, leaves, specs) -> int:
    total = 0
    for leaf, spec in zip(leaves, specs):
        parts = [math.prod(jmesh.shape[a] for a in ((p,) if isinstance(p, str) else p))
                 if p is not None else 1 for p in spec]
        parts += [1] * (len(leaf.shape) - len(parts))
        n = math.prod(-(-d // k) for d, k in zip(leaf.shape, parts))
        total += n * leaf.dtype.itemsize
    return total


def _jax_argument_bytes(jcfg, name, jmesh) -> int:
    spec = jshapes.SHAPES[name]
    rules = jshd.ShardingRules.for_config(jmesh, jcfg, decode=spec.kind == "decode")
    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    ov = dryrun.DRYRUN_OVERRIDES.get(jcfg.name, {})
    ins = jshapes.input_specs(jcfg, name)

    def tree_bytes(tree, specs):
        return _jax_shard_bytes(jmesh, jax.tree_util.tree_leaves(tree),
                                jax.tree_util.tree_leaves(specs, is_leaf=is_spec))

    def batch_bytes(batch):
        return sum(tree_bytes([v], [rules.spec(("batch",) + (None,) * (len(v.shape) - 1),
                                               v.shape)]) for v in batch.values())

    if spec.kind == "train":
        ocfg = joptim.OptConfig(opt_dtype=ov.get("opt_dtype", "float32"))
        return tree_bytes(jts.abstract_state(jcfg, ocfg), jts.state_pspecs(jcfg, ocfg, rules)) \
            + batch_bytes(ins["batch"])
    params = tree_bytes(jmodel.abstract(jcfg), jmodel.partition_pspecs(jcfg, rules))
    if spec.kind == "prefill":
        return params + batch_bytes(ins["batch"])
    cache = ins["cache"]
    return params + tree_bytes(cache, jserve.cache_pspecs(jcfg, rules, cache)) + \
        tree_bytes([ins["tokens"]], [rules.spec(("batch", None), ins["tokens"].shape)])


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_jax(arch):
    tcfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    ov = dryrun.DRYRUN_OVERRIDES.get(arch, {})
    ocfg = toptim.OptConfig(opt_dtype=ov.get("opt_dtype", "float32"))
    for multi_pod in (False, True):
        tmesh = make_production_mesh(multi_pod=multi_pod)
        jmesh = AbstractMesh(tuple(tmesh.shape.values()), tuple(tmesh.shape))
        for name, spec in shapes.SHAPES.items():
            got = sum(dryrun.argument_bytes(tcfg, spec, tmesh, ocfg).values())
            assert got == _jax_argument_bytes(jcfg, name, jmesh), (name, multi_pod)


def _cases(cfg):
    """Each shape kind at a small shape, and long_500k where it applies."""
    out = [shapes.ShapeSpec("train", "train", 64, 4), shapes.ShapeSpec("prefill", "prefill", 64, 2),
           shapes.ShapeSpec("decode", "decode", 32768, 4)]
    if cfg.family in shapes.SUBQUADRATIC_FAMILIES:
        out.append(shapes.SHAPES["long_500k"])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_counts_equal_full_depth_runs(arch):
    """The flops carried from one and two units equal a run of three units
    (the smoke config's leading and remainder layers kept), exactly.  The
    operations are carried the same way and are an estimate: at one unit
    a ``.contiguous()`` of an expanded cache position copies nothing
    (RecurrentGemma's decode: one operation off at three units); they
    lie within 1%.  Grok-1, whose cell trains in 8 microbatches, trains
    in 2 here."""
    cfg = dryrun.with_units(make_smoke(get_config(arch)), 3)
    for spec in _cases(cfg):
        mb = 2 if spec.kind == "train" and arch == "grok-1-314b" else 1
        full = dryrun.measure(cfg, spec, microbatches=mb)
        cut = dryrun.count_cell(cfg, spec, microbatches=mb)
        assert cut["flops"] == full["flops"] > 0, spec.kind
        assert abs(cut["ops"] - full["ops"]) <= 0.01 * full["ops"], spec.kind


@pytest.mark.parametrize("arch", ["qwen3-8b"])
def test_length_fit_equals_a_full_length_prefill(arch):
    """Past ``SEQ_CHECK`` a prefill's flops come from the quadratic through
    ``SEQ_POINTS``; at 7,168 they equal the run's."""
    cfg = dryrun.with_units(make_smoke(get_config(arch)), 1)
    spec = shapes.ShapeSpec("prefill", "prefill", 7168, 1)
    cut = dryrun.count_cell(cfg, spec)
    assert "checked at" in cut["method"]
    assert cut["flops"] == dryrun.measure(cfg, spec)["flops"]


def test_full_width_decode_cell():
    """qwen3-8b ``decode_32k`` at full width: the carried counts equal the
    full-depth run's, and the flops lie within ``FLOPS_FACTOR`` of
    ``model_flops_estimate``."""
    cfg, spec = get_config("qwen3-8b"), shapes.SHAPES["decode_32k"]
    cut = dryrun.count_cell(cfg, spec)
    assert cut["flops"] == dryrun.measure(cfg, spec)["flops"]
    ratio = cut["flops"] / rf.model_flops_estimate(cfg, "decode", spec.batch, spec.seq)
    assert 1 / FLOPS_FACTOR <= ratio <= FLOPS_FACTOR, ratio


def test_dryrun_cli_writes_an_ok_cell(tmp_path):
    """The cell's memory term is the bytes the decode step must move,
    ``decode_bound_ms``'s, over the mesh's devices.  The 16 x 16 cell runs
    placed in a worker: its collectives by kind sum to its total, the
    roofline's collective term; the 1 x 1 cell has none.  This process
    holds no process group after."""
    import torch.distributed as dist

    rc = dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--out", str(tmp_path)])
    assert rc == 0 and not dist.is_initialized()
    cfg = get_config("mamba2-130m")
    for mesh, chips in (("1x1", 1), ("16x16", 256)):
        res = json.loads((tmp_path / f"mamba2-130m__long_500k__{mesh}.json").read_text())
        assert res["status"] == "ok" and res["memory"]["fits_80GB"]
        coll, roof = res["collectives"], res["roofline"]
        if chips == 1:
            assert coll is None and roof["coll_bytes_per_device"] is None
        else:
            assert set(coll) == set(dryrun.COLLECTIVES) | {"total"}
            assert coll["total"] == sum(coll[k] for k in dryrun.COLLECTIVES) > 0
            assert roof["coll_bytes_per_device"] == coll["total"]
            assert roof["t_collective_s"] == coll["total"] / rf.LINK_BW
            assert res["collective_calls"]["total"] > 0
        assert res["roofline"]["bytes_per_device"] == rf.decode_bytes(cfg, 1, 524288) / chips
    assert res["roofline"]["t_memory_s"] * 256e3 == pytest.approx(
        rf.decode_bound_ms(cfg, 1, 524288), rel=1e-12)
    assert dryrun.run_cell(dryrun.Cell("qwen3-8b", "long_500k", ("1x1",)))[0]["status"] == "skipped"


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_step_meter_counts_the_flops_flop_counter_mode_counts(kind):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = make_smoke(get_config("deepseek-v2-lite-16b"))
    spec = shapes.ShapeSpec(kind, kind, 3072 if kind == "prefill" else 64, 2)
    step = dryrun._step(cfg, spec, 1, toptim.OptConfig())
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad, FlopCounterMode(display=False) as fc:
        step()
    assert dryrun.measure(cfg, spec)["flops"] == fc.get_total_flops() > 0


def test_step_meter_frees_storages():
    with dryrun.StepMeter() as m:
        a = torch.empty(1 << 20, dtype=torch.uint8, device="meta")
        b = a.view(1024, 1024)  # a view adds no storage
        del a, b
        c = torch.empty(1 << 19, dtype=torch.uint8, device="meta")
        del c
    assert m.peak == 1 << 20 and m.live == 0 and m.ops == 3


@pytest.mark.parametrize("phase", [17, 18, 19, 20])
def test_bounds_pinned(phase):
    """The bounds phases 17–20 print, as ``chip_smoke.py`` computed them
    before they moved into ``launch/roofline.py``."""
    q, d = get_config("qwen3-8b"), get_config("deepseek-v2-lite-16b")
    r, w, m = (get_config(a) for a in ("recurrentgemma-9b", "whisper-large-v3", "mamba2-130m"))
    if phase == 17:
        assert rf.prefill_bound_ms(q, 2, 4096) == (135.3880448398625, 133898776346624,
                                                   "operations")
        assert rf.decode_bound_ms(q, 16, 64.0) == 4.563563290746269
    elif phase == 18:
        assert rf.prefill_bound_ms(d, 2, 4096) == (45.30233398668554, 44804008312832.0,
                                                   "operations")
        assert rf.decode_bound_ms(d, 16, 64.0, picked=100) == 1.1838512907462688
    elif phase == 19:
        assert rf.prefill_bound_ms(r, 2, 4096) == (158.16487131502527, 156425057730560,
                                                   "operations")
        assert rf.decode_bound_ms(r, 16, 64.0) == 5.621729432835821
        assert rf.prefill_bound_ms(w, 2, 3584) == (21.598679930434784, 21361094451200,
                                                   "operations")
        assert rf.decode_bound_ms(w, 16, 64.0) == 1.764468919402985
    else:
        assert rf.train_bound_ms(m, 8, 512, (2_000_000_000, 300_000_000)) == \
            (3.567183985892821, "operations")
        assert rf.train_bound_ms(q.replace(n_layers=4), 4, 1024,
                                 (24_200_000_000, 4_000_000_000)) == (35.06026771413549,
                                                                      "operations")
    assert (rf.PEAK_FLOPS, rf.HBM_BW) == (989e12, 3.35e12)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b", "recurrentgemma-9b"])
def test_step_bytes_are_the_bounds_bytes(arch):
    """``step_bytes``, the dry run's memory term, is the count the serving
    and training bounds read: a decode's at the shape's whole context
    with each MoE layer's ``top_k`` experts (the fewest a step picks), a
    prefill's weights, a train step's state; each a floor under the
    step's arguments read once and its state written."""
    cfg = get_config(arch)
    assert rf.step_bytes(cfg, "decode", 128, 32768) == rf.decode_bytes(
        cfg, 128, 32768, picked=cfg.top_k * rf.moe_layers(cfg))
    assert rf.decode_bound_ms(cfg, 128, 32768) == rf.decode_bytes(cfg, 128, 32768) / 3.35e12 * 1e3
    assert rf.step_bytes(cfg, "prefill", 32, 32768) == 2 * rf.llm_params(cfg)
    assert rf.step_bytes(cfg, "train", 256, 4096, state_bytes=30, param_bytes=10) == 70
    spec, ocfg = shapes.SHAPES["decode_32k"], toptim.OptConfig()
    args = dryrun.argument_bytes(cfg, spec, make_debug_mesh(1, 1), ocfg)
    state = 2 * rf.state_bytes_a_layer(cfg, "rec", 128) * rf.kind_layers(cfg).get("rec", 0)
    assert 0 < rf.step_bytes(cfg, "decode", 128, 32768) <= sum(args.values()) + state
