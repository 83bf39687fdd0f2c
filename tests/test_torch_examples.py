"""The port's examples (``repro_torch.examples``) against the JAX package.

Each example's ``main`` runs on the CPU (``--device cpu``) at the JAX
example's own keys, seeds and sizes; its integers are held equal to the
JAX package's, run on the same keys through ``repro.filters``,
``repro.data.pipeline`` and ``repro.serve.prefix_cache`` in plain loops
(a jitted single insert a batch, not the JAX example's ``lax.scan``):
the QF's ``n`` after the delete, the buffered QF's flushes, the cascade's
levels and merges, ``auto_grow``'s final ``q`` and ``n``, the pipeline's
documents seen, kept and dropped, and the prefix cache's remote probes
and hits.

Two choices keep the JAX side's compiles down.  The JAX prefix cache
holds its table at q = 14 (``auto_scale=False``), where the example's
shrinks it: each of its geometries compiles its own programs (about
28 s on the CPU).  The hits do not depend on the geometry: a resize
keeps every 30-bit fingerprint, so the table answers for the same
fingerprints at any q.  The JAX pipeline runs under
``jax.disable_jit()``: its one ``_dedup`` call of 512 digests runs
eagerly in less time than its cascade's programs take to compile (about
6 s against 13).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import filters as jfilters
from repro.data.pipeline import DedupPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.serve.prefix_cache import PrefixCacheFilter as JaxPrefixCache
from repro_torch.examples import dedup_pipeline, quickstart, serve_prefix_cache, train_e2e

CPU = ["--device", "cpu"]


def _jax_keys():
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.integers(0, 2**32, 50_000, dtype=np.int64).astype(np.uint32))


def _jax_ingest(name, batches, **spec):
    cfg, st = jfilters.make(name, **spec)
    step = jax.jit(lambda s, ks: jfilters.insert(cfg, s, ks))
    for ks in batches:
        st = step(st, ks)
    return cfg, st


def _jax_quickstart_flash() -> dict:
    """Sections 1-3 of ``examples/quickstart.py``: the QF, the buffered QF
    and the cascade."""
    keys = _jax_keys()
    cfg, st = jfilters.make("qf", q=16, r=12)
    st = jfilters.insert(cfg, st, keys[:40_000])
    st = jfilters.delete(cfg, st, keys[:10_000])
    out = {"qf_n_after_delete": int(jfilters.stats(cfg, st)["n"])}
    batches = keys.reshape(25, 2_000)
    _, bst = _jax_ingest("buffered_qf", batches, ram_q=12, disk_q=16, p=28)
    out["bqf_flushes"] = jfilters.to_iolog(bst.io).flushes
    ccfg, cst = _jax_ingest("cascade", batches, ram_q=12, p=28, fanout=2, levels=4)
    s = jfilters.stats(ccfg, cst)
    out.update(cf_levels=int(s["nonempty_levels"]), cf_merges=int(s["merges"]))
    return out


def _jax_quickstart_grow() -> dict:
    """Section 5 of ``examples/quickstart.py``: ``auto_grow`` from q = 10."""
    keys = _jax_keys()
    gcfg, gst = jfilters.make("qf", q=10, r=18)
    for i in range(0, 50_000, 1_000):
        gcfg, gst = jfilters.auto_grow(gcfg, gst, keys[i : i + 1_000])
    return {"auto_grow_q": gcfg.q, "auto_grow_n": int(jfilters.stats(gcfg, gst)["n"])}


def _jax_dedup() -> dict:
    """``examples/dedup_pipeline.py``'s pipeline and batches."""
    pipe = JaxPipeline(JaxPipelineConfig(
        seq_len=512, batch_size=4, duplicate_fraction=0.35,
        dedup_ram_q=12, dedup_p=30, dedup_fanout=4, dedup_levels=4,
    ))
    with jax.disable_jit():
        for _ in pipe.batches(10, docs_per_step=512):
            pass
    s = pipe.state
    return {"docs_seen": s.docs_seen, "docs_kept": s.docs_kept,
            "docs_dropped": s.docs_dropped}


def _jax_prefix_cache() -> dict:
    """``examples/serve_prefix_cache.py``'s 20 request batches."""
    pc = JaxPrefixCache(q=14, r=16, auto_scale=False)
    rng = np.random.default_rng(0)
    catalog, hits_total = [], 0
    for _ in range(20):
        prompts = rng.integers(0, 32000, (32, 64))
        if catalog:
            for j in range(int(0.4 * 32)):
                prompts[j] = catalog[rng.integers(0, len(catalog))]
        hits = np.asarray(pc.check_and_insert(prompts))
        catalog.extend(list(prompts[~hits]))
        hits_total += int(hits.sum())
    return {"remote_probes_naive": 20 * 32, "remote_probes_with_filter": hits_total}


@pytest.fixture(scope="module")
def jax_side() -> dict:
    out = {}
    for job in (_jax_quickstart_flash, _jax_prefix_cache, _jax_dedup, _jax_quickstart_grow):
        out.update(job())
    return out


@pytest.fixture(scope="module")
def quick():
    return quickstart.main(CPU)


@pytest.fixture(scope="module")
def dedup():
    return dedup_pipeline.main(CPU)


@pytest.fixture(scope="module")
def cache():
    return serve_prefix_cache.main(CPU)


@pytest.mark.parametrize("name", ["qf_n_after_delete", "bqf_flushes", "cf_levels",
                                  "cf_merges", "auto_grow_q", "auto_grow_n"])
def test_quickstart_matches_jax(jax_side, quick, name):
    assert quick[name] == jax_side[name]


def test_quickstart_answers(quick):
    for name in ("qf_all_present", "cf_all_present", "pallas_all_present",
                 "auto_grow_all_present"):
        assert quick[name] is True, name
    assert not quick["auto_grow_overflow"]
    assert quick["qf_fp_rate"] < 2 * 0.61 * 2**-12


def test_quickstart_pallas_section_equals_the_plain_path():
    keys = quickstart.uint32_keys(np.random.default_rng(0), 50_000, "cpu")
    got = quickstart.pallas_hits(keys)
    assert got.all() and bool((got == quickstart.pallas_hits(keys, "reference")).all())


@pytest.mark.parametrize("name", ["docs_seen", "docs_kept", "docs_dropped"])
def test_dedup_pipeline_matches_jax(jax_side, dedup, name):
    assert dedup[name] == jax_side[name]


def test_dedup_pipeline_stats(dedup):
    assert dedup["digests"] == dedup["docs_kept"]
    assert dedup["docs_seen"] == dedup["docs_kept"] + dedup["docs_dropped"]


@pytest.mark.parametrize("name", ["remote_probes_naive", "remote_probes_with_filter"])
def test_serve_prefix_cache_matches_jax(jax_side, cache, name):
    assert cache[name] == jax_side[name]


def test_train_e2e_smoke(tmp_path):
    out = train_e2e.main(["--smoke", "--steps", "2", "--ckpt-dir", str(tmp_path)] + CPU)
    assert (out["steps"], out["step"], out["resumed_from"]) == (2, 1, 0)
    assert math.isfinite(out["loss"]) and out["tokens_per_s"] > 0
    assert out["docs_seen"] == out["docs_kept"] + out["docs_dropped"] > 0


def test_train_e2e_passes_the_example_arguments(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(train_e2e.train, "run", lambda argv: seen.append(argv) or {})
    train_e2e.main(["--device", "cpu"])
    train_e2e.main(["--steps", "3", "--ckpt-dir", str(tmp_path)])
    first, second = seen
    assert first[:6] == ["--arch", "mamba2-130m", "--batch", "8", "--seq", "512"]
    assert first[-4:] == ["--device", "cpu", "--steps", "200"]
    assert second[second.index("--ckpt-dir") + 1] == str(tmp_path)
    assert second[-2:] == ["--steps", "3"] and "--ckpt-every" in second
