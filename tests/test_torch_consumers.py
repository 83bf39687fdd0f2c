"""The port's two filter consumers against the JAX package's: the dedup
pipeline (``repro_torch.data.pipeline``) and the prefix cache
(``repro_torch.serve.prefix_cache``), state on the CPU.

The cases are those of ``tests/test_infra.py``'s ``TestPipeline`` (at
``dedup_ram_q`` 10 in place of 16), ``tests/test_incremental.py``'s
``TestPipelineMigrationSnapshot`` and ``TestServingCache``, and
``tests/test_resize.py``'s ``TestPipelineGrowth``.  Each drives the same
corpus (or digests, or prompts) through both packages' consumers and
holds the keep masks, hit masks, counters and filter leaves equal (the
port's snapshot leaves are ``filters.to_numpy``'s, the JAX pipeline's
``tree_leaves``).  Snapshots then cross between the packages both ways,
mid-settle and mid-migration, with the config converted to the other
package's type (a pickled config names its package's class).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DedupPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.filters import buffered as jbuffered
from repro.filters import cascade as jcascade
from repro.filters import incremental_resize as jir
from repro.filters import qf_filter as jqf_filter
from repro.filters import steady as jsteady
from repro.serve.prefix_cache import PrefixCacheFilter as JaxPrefixCache
from repro_torch import filters as tf
from repro_torch.data.pipeline import DedupPipeline, PipelineConfig
from repro_torch.filters import buffered, cascade, qf_filter, steady
from repro_torch.filters import incremental_resize as tir
from repro_torch.serve.prefix_cache import PrefixCacheFilter

_MODULES = {
    "port": (qf_filter, steady, buffered, cascade, tir),
    "jax": (jqf_filter, jsteady, jbuffered, jcascade, jir),
}
_CFG_NAMES = ("QFilterConfig", "SteadyQFConfig", "BufferedQFConfig",
              "CascadeConfig", "MigratingQFConfig")


def _convert(cfg, to: str):
    """A filter config as the other package's config type."""
    if not hasattr(cfg, "_fields"):
        return cfg
    name = type(cfg).__name__
    assert name in _CFG_NAMES, name
    cls = next(getattr(m, name) for m in _MODULES[to] if hasattr(m, name))
    return cls(*(_convert(v, to) for v in cfg))


def _snap_as(snap: dict, to: str) -> dict:
    return dict(snap, filter_cfg=_convert(snap["filter_cfg"], to))


def _jleaves(state):
    return [np.array(x) for x in jax.tree_util.tree_leaves(state)]


def _assert_leaves(jleaves, tleaves, what=""):
    assert len(jleaves) == len(tleaves), what
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _assert_same_pipeline(jpipe, pipe, what=""):
    assert tuple(_convert(jpipe.filter_cfg, "port")) == tuple(pipe.filter_cfg), what
    assert vars(jpipe.state).keys() == vars(pipe.state).keys()
    for k in ("docs_seen", "docs_kept", "docs_dropped"):
        assert getattr(jpipe.state, k) == getattr(pipe.state, k), (what, k)
    _assert_leaves(
        _jleaves(jpipe.filter_state), tf.to_numpy(pipe.filter_cfg, pipe.filter_state),
        what,
    )


def _pipes(**spec):
    return (
        JaxPipeline(JaxPipelineConfig(**spec)),
        DedupPipeline(PipelineConfig(**spec), device="cpu"),
    )


def _ids(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


# -- TestPipeline (tests/test_infra.py), at dedup_ram_q = 10 ----------------


def test_dedup_drops_duplicates():
    jpipe, pipe = _pipes(seq_len=128, batch_size=2, duplicate_fraction=0.5, seed=1,
                         dedup_ram_q=10)
    batches = list(pipe.batches(3, docs_per_step=128))
    jbatches = list(jpipe.batches(3, docs_per_step=128))
    _assert_same_pipeline(jpipe, pipe)
    assert len(batches) == 3
    assert pipe.state.docs_dropped > 0
    rate = pipe.state.docs_dropped / pipe.state.docs_seen
    assert 0.3 < rate < 0.7
    for b, jb in zip(batches, jbatches):
        assert b["tokens"].shape == (2, 128) and b["tokens"].dtype == torch.int32
        assert b["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))
        np.testing.assert_array_equal(b["targets"].numpy(), np.asarray(jb["targets"]))
        flat_t = b["tokens"].numpy().ravel()
        flat_y = b["targets"].numpy().ravel()
        np.testing.assert_array_equal(flat_t[1:], flat_y[:-1])


def test_zero_duplicates_passthrough():
    pipe = DedupPipeline(
        PipelineConfig(seq_len=64, batch_size=2, duplicate_fraction=0.0, seed=2,
                       dedup_ram_q=10),
        device="cpu",
    )
    list(pipe.batches(2, docs_per_step=64))
    # only false positives (~n * 2^-p) may drop; at this scale: none
    assert pipe.state.docs_dropped <= 1


def test_snapshot_restore_preserves_filter():
    spec = dict(seq_len=64, batch_size=2, duplicate_fraction=0.3, seed=3,
                dedup_ram_q=10)
    jpipe, pipe = _pipes(**spec)
    list(pipe.batches(2, docs_per_step=128))
    list(jpipe.batches(2, docs_per_step=128))
    snap = pipe.snapshot()
    _assert_leaves(jpipe.snapshot()["filter_leaves"], snap["filter_leaves"])
    pipe2 = DedupPipeline(PipelineConfig(**spec), device="cpu")
    pipe2.restore(snap)
    assert pipe2.state.docs_seen == pipe.state.docs_seen
    ids = np.asarray(pipe.corpus._originals[:50], np.uint32)
    assert not pipe2._dedup(ids).any()


def test_dedup_spec_matches_jax():
    for spec in (
        dict(),
        dict(dedup_family="qf", dedup_ram_q=9, dedup_p=28),
        dict(dedup_family="steady_qf", dedup_ram_q=12, dedup_p=30, dedup_chunk=64),
        dict(dedup_frozen_below=1),
        dict(dedup_frozen_below="auto", dedup_ram_q=20, dedup_p=40, dedup_levels=4),
    ):
        assert PipelineConfig(**spec).dedup_spec() == JaxPipelineConfig(**spec).dedup_spec()
    with pytest.raises(ValueError):
        PipelineConfig(dedup_family="bloom").dedup_spec()


def test_consumers_without_a_device_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DedupPipeline(PipelineConfig(dedup_family="qf", dedup_ram_q=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefixCacheFilter(q=8, r=10, family="steady_qf")


@pytest.mark.parametrize("device, backend", [("cpu", "reference"), ("cuda", "pallas")])
def test_pipeline_backend_follows_its_device(monkeypatch, device, backend):
    """A pipeline on the card makes its filter on the kernel path, one on
    the CPU on the plain path (the filter itself is not built here: this
    CPU build has no card)."""
    made = {}

    def make(family, device=None, **spec):
        made.update(spec, device=device)
        return None, None

    from repro_torch.core import quotient_filter as tqf

    monkeypatch.setattr(tqf, "resolve_device", lambda d: torch.device(device))
    monkeypatch.setattr(tf, "make", make)
    cfg = PipelineConfig(dedup_family="steady_qf", dedup_ram_q=12, dedup_p=30)
    DedupPipeline(cfg)
    assert made == dict(cfg.dedup_spec(), backend=backend, device=torch.device(device))


# -- TestPipelineMigrationSnapshot (tests/test_incremental.py) --------------

MIGRATION_SPEC = dict(seq_len=64, batch_size=2, duplicate_fraction=0.0, seed=21,
                      dedup_family="qf", dedup_ram_q=8, dedup_p=28, dedup_chunk=64)


def _ingest_until_migrating(pipe, rng, ingested, batch=48, limit=64):
    for _ in range(limit):
        ids = _ids(rng, batch)
        ingested.append(ids)
        keep = pipe._dedup(ids)
        if tir.is_migrating(pipe.filter_cfg) or jir.is_migrating(pipe.filter_cfg):
            return keep
    raise AssertionError("never entered migration")


@functools.lru_cache(maxsize=None)
def _jax_migration_snapshot():
    jpipe = JaxPipeline(JaxPipelineConfig(**MIGRATION_SPEC))
    _ingest_until_migrating(jpipe, np.random.default_rng(5), [])
    return jpipe.snapshot()


def test_snapshot_restore_mid_migration_resumes():
    pipe = DedupPipeline(PipelineConfig(**MIGRATION_SPEC), device="cpu")
    rng = np.random.default_rng(5)
    ingested = []
    _ingest_until_migrating(pipe, rng, ingested)
    cursor_at_snap = int(pipe.filter_state.cursor)
    snap = pipe.snapshot()
    jsnap = _jax_migration_snapshot()
    assert tuple(_convert(jsnap["filter_cfg"], "port")) == tuple(snap["filter_cfg"])
    _assert_leaves(jsnap["filter_leaves"], snap["filter_leaves"], "snapshot")

    pipe2 = DedupPipeline(PipelineConfig(**MIGRATION_SPEC), device="cpu")
    pipe2.restore(snap)
    assert tir.is_migrating(pipe2.filter_cfg)
    assert int(pipe2.filter_state.cursor) == cursor_at_snap
    for ids in ingested:
        assert not pipe2._dedup(ids).any()
    for _ in range(64):
        pipe2._dedup(_ids(rng, 48))
        if not tir.is_migrating(pipe2.filter_cfg):
            break
    assert not tir.is_migrating(pipe2.filter_cfg)
    assert not bool(tf.stats(pipe2.filter_cfg, pipe2.filter_state)["overflow"])


def test_mismatched_snapshot_still_refused():
    pa = DedupPipeline(PipelineConfig(dedup_family="qf", dedup_ram_q=8, dedup_p=28),
                       device="cpu")
    pb = DedupPipeline(PipelineConfig(dedup_family="qf", dedup_ram_q=9, dedup_p=28),
                       device="cpu")
    before = tf.to_numpy(pb.filter_cfg, pb.filter_state)
    snap = pa.snapshot()
    snap["filter_leaves"] = snap["filter_leaves"][:-1]  # corrupt
    with pytest.raises(ValueError):
        pb.restore(snap)
    snap = pa.snapshot()
    snap["filter_leaves"][0] = snap["filter_leaves"][0].view(np.int32)  # wrong dtype
    with pytest.raises(ValueError):
        pb.restore(snap)
    # a refused snapshot leaves the pipeline as it was
    assert pb.filter_cfg.q == 9
    _assert_leaves(before, tf.to_numpy(pb.filter_cfg, pb.filter_state))
    # legacy snapshots stored tuple(cfg)
    snap = pb.snapshot()
    snap["filter_cfg"] = tuple(snap["filter_cfg"])
    pb.restore(snap)
    assert pb.filter_cfg == qf_filter.QFilterConfig(q=9, r=19)


# -- TestPipelineGrowth (tests/test_resize.py) ------------------------------


def test_dedup_pipeline_deepens_and_snapshots_across_growth():
    spec = dict(seq_len=64, batch_size=2, duplicate_fraction=0.0, seed=9,
                dedup_ram_q=7, dedup_p=30, dedup_fanout=4, dedup_levels=1)
    jpipe, pipe = _pipes(**spec)
    rng = np.random.default_rng(3)
    all_ids = []
    for _ in range(24):  # ~1.5k uniques vs bottom capacity 384
        ids = _ids(rng, 64)
        all_ids.append(ids)
        np.testing.assert_array_equal(pipe._dedup(ids), jpipe._dedup(ids))
    _assert_same_pipeline(jpipe, pipe, "after 24 batches")
    assert pipe.filter_cfg.levels > 1  # grew
    assert not bool(tf.stats(pipe.filter_cfg, pipe.filter_state)["overflow"])
    snap = pipe.snapshot()
    pipe2 = DedupPipeline(PipelineConfig(**spec), device="cpu")
    pipe2.restore(snap)
    assert pipe2.filter_cfg == pipe.filter_cfg
    assert not pipe2._dedup(all_ids[0]).any()


# -- snapshots across the packages: the steady family -----------------------

STEADY_SPEC = dict(seq_len=64, batch_size=2, duplicate_fraction=0.0, seed=4,
                   dedup_family="steady_qf", dedup_ram_q=9, dedup_p=26,
                   dedup_chunk=32)


def _steady_pipes_until(stop):
    """Both pipelines fed the same batches until ``stop(port pipeline)``;
    returns them and the batches."""
    jpipe, pipe = _pipes(**STEADY_SPEC)
    rng = np.random.default_rng(8)
    ingested = []
    for _ in range(64):
        ids = _ids(rng, 48)
        ingested.append(ids)
        np.testing.assert_array_equal(pipe._dedup(ids), jpipe._dedup(ids))
        if stop(pipe):
            return jpipe, pipe, ingested
    raise AssertionError("the stop condition never held")


def _mid_settle(pipe):
    st = pipe.filter_state
    return not tir.is_migrating(pipe.filter_cfg) and bool(st.cursor < st.src_n)


def _mid_migration(pipe):
    return tir.is_migrating(pipe.filter_cfg)


@pytest.mark.parametrize("when", ["mid-settle", "mid-migration"])
def test_snapshots_cross_between_the_packages(when):
    """A JAX pipeline's snapshot restores into the port's pipeline and a
    port snapshot into the JAX pipeline, leaf for leaf; both then dedup
    the same next batches alike."""
    jpipe, pipe, ingested = _steady_pipes_until(
        _mid_settle if when == "mid-settle" else _mid_migration
    )
    _assert_same_pipeline(jpipe, pipe, when)
    tsnap, jsnap = pipe.snapshot(), jpipe.snapshot()

    port_from_jax = DedupPipeline(PipelineConfig(**STEADY_SPEC), device="cpu")
    port_from_jax.restore(_snap_as(jsnap, "port"))
    jax_from_port = JaxPipeline(JaxPipelineConfig(**STEADY_SPEC))
    jax_from_port.restore(_snap_as(tsnap, "jax"))
    _assert_same_pipeline(jax_from_port, port_from_jax, "restored")
    for ids in ingested:
        assert not port_from_jax._dedup(ids).any()
    rng = np.random.default_rng(9)
    for i in range(6):
        ids = _ids(rng, 48)
        np.testing.assert_array_equal(port_from_jax._dedup(ids), jax_from_port._dedup(ids))
    _assert_same_pipeline(jax_from_port, port_from_jax, "after 6 more batches")


# -- the prefix cache -------------------------------------------------------


def _prompts(rng, n, length=24):
    return [rng.integers(0, 1000, length, dtype=np.int64) for _ in range(n)]


def test_prefix_cache_grows_incrementally_and_shrinks_after_eviction():
    """TestServingCache, with every hit mask and the final filter equal to
    the JAX prefix cache's."""
    pc = PrefixCacheFilter(q=8, r=18, chunk=128, device="cpu")
    jpc = JaxPrefixCache(q=8, r=18, chunk=128)
    prompts = _prompts(np.random.default_rng(40), 700)
    for i in range(0, 700, 50):
        batch = np.asarray(prompts[i : i + 50])
        hits = pc.check_and_insert(batch)
        assert hits.shape == (50,) and hits.dtype == bool
        np.testing.assert_array_equal(hits, jpc.check_and_insert(batch))
    for i in range(0, 700, 100):
        assert pc.check_and_insert(np.asarray(prompts[i : i + 50])).all()
    grown_q = pc.cfg.dst.q if tir.is_migrating(pc.cfg) else pc.cfg.q
    assert grown_q > 8
    for i in range(0, 650, 50):
        pc.evict(np.asarray(prompts[i : i + 50]))
    assert not tir.is_migrating(pc.cfg)  # evict settles first
    assert pc.cfg.q <= grown_q
    for i in range(0, 700, 100):
        jpc.check_and_insert(np.asarray(prompts[i : i + 50]))
    for i in range(0, 650, 50):
        jpc.evict(np.asarray(prompts[i : i + 50]))
    assert tuple(_convert(jpc.cfg, "port")) == tuple(pc.cfg)
    _assert_leaves(_jleaves(jpc.state), tf.to_numpy(pc.cfg, pc.state))
    assert pc.load == pytest.approx(jpc.load)


@pytest.mark.parametrize("family", ["qf", "steady_qf"])
def test_prefix_cache_first_copy_of_a_repeated_prompt_wins(family):
    """Within one batch the first copy of a prompt misses and every later
    copy hits (a stable sort), as in the JAX prefix cache; prompts of an
    earlier batch hit."""
    spec = dict(q=10, r=16, chunk=64, family=family)
    pc = PrefixCacheFilter(device="cpu", **spec)
    jpc = JaxPrefixCache(**spec)
    distinct = _prompts(np.random.default_rng(41), 40)
    order = np.random.default_rng(42).integers(0, 40, 160)
    batch = np.asarray([distinct[i] for i in order])
    hits = pc.check_and_insert(batch)
    np.testing.assert_array_equal(hits, jpc.check_and_insert(batch))
    _, first = np.unique(order, return_index=True)
    want = np.ones(160, bool)
    want[first] = False
    np.testing.assert_array_equal(hits, want)
    again = pc.check_and_insert(batch[::-1])
    assert again.all()
    np.testing.assert_array_equal(again, jpc.check_and_insert(batch[::-1]))
    pc.evict(np.asarray(distinct[:20]))
    jpc.evict(np.asarray(distinct[:20]))
    _assert_leaves(_jleaves(jpc.state), tf.to_numpy(pc.cfg, pc.state))
    left = np.setdiff1d(np.unique(order), np.arange(20)).size
    assert pc.can_evict and int(tf.stats(pc.cfg, pc.state)["n"]) == left
