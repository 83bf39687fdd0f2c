"""The port's blocking resize against the JAX package's, bit for bit.

The same numpy keys go through ``repro.filters`` and
``repro_torch.filters`` (state on the CPU) for ``qf``, ``buffered_qf``,
``cascade`` and the frozen cascade (``frozen_below=1``): ``grow``,
``resize``, ``shrink``, the ``needs_resize``/``needs_shrink`` predicates
and the ``auto_grow`` driver.  After every step the configs must be
equal, and the states too: planes, fuse tables and runs, ``n``,
``overflow`` and the ``IOCounters`` (float32 counters updated in the
same order, so no tolerance).  The cases mirror ``tests/test_resize.py``
without the sharded family.

The JAX side runs once per case under ``backend="pallas"`` (its bit-exact
kernel lowering on the CPU; ``"reference"`` for the frozen cascade, as
``tests/test_torch_xor_fuse.py`` runs it), the port's under both
spellings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filters as jf
from repro.core import quotient_filter as jqf
from repro_torch import filters as tf
from repro_torch.core import quotient_filter as tqf

# name -> (family, spec, chunk, growth): the non-sharded cases of
# test_resize.py (a frozen cascade added), ingested to ``growth`` times
# their initial capacity by auto_grow; chunks stay below each slack and
# divide every capacity, so the JAX package compiles each insert once
CASES = {
    "qf": ("qf", dict(q=8, r=16), 128, 8),
    "buffered_qf": ("buffered_qf", dict(ram_q=7, disk_q=10, p=26), 48, 4),
    "cascade": ("cascade", dict(ram_q=7, p=30, fanout=4, levels=1), 48, 8),
    "frozen cascade": (
        "cascade", dict(ram_q=7, p=30, fanout=2, levels=2, frozen_below=1), 48, 3
    ),
}
BACKENDS = ["reference", "pallas"]


def _keys(seed, n, lo=0, hi=2**31):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=n, dtype=np.int64).astype(np.uint32)


def _tkeys(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _jax_backend(spec):
    return "reference" if spec.get("frozen_below") is not None else "pallas"


def _assert_same(jcfg, jstate, tcfg, tstate, what=""):
    assert tcfg._asdict() == jcfg._asdict(), what
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    tleaves = tf.to_numpy(tcfg, tstate)
    assert len(jleaves) == len(tleaves), what
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _initial_capacity(family, cfg) -> int:
    if family == "qf":
        return cfg.core.capacity
    if family == "buffered_qf":
        return cfg.disk.capacity
    return cfg.level_cfg(cfg.levels - 1).capacity


def _to_jax(family, tcfg, tstate):
    """The JAX package's ``(cfg, state)`` holding the port's state."""
    jcfg, template = jf.make(family, **tcfg._asdict())
    treedef = jax.tree_util.tree_structure(template)
    leaves = [jnp.asarray(a) for a in tf.to_numpy(tcfg, tstate)]
    return jcfg, jax.tree_util.tree_unflatten(treedef, leaves)


def _fill(family, spec, backend, n, chunk):
    """A port state with ``n`` keys inserted in batches of ``chunk``."""
    cfg, st = tf.make(family, device="cpu", **dict(spec, backend=backend))
    ks = _keys(1, n)
    for i in range(0, n, chunk):
        st = tf.insert(cfg, st, _tkeys(ks[i : i + chunk]))
    return cfg, st, ks


def _step_as_jax(family, op, tcfg, tstate, **kw):
    """One structural op of each package on the same state: the port's
    result, checked equal to the JAX package's on the same leaves."""
    jcfg, jstate = _to_jax(family, tcfg, tstate)
    tcfg2, tstate2 = getattr(tf, op)(tcfg, tstate, **kw)
    jcfg2, jstate2 = getattr(jf, op)(jcfg, jstate, **kw)
    _assert_same(jcfg2, jstate2, tcfg2, tstate2, f"{op}{kw or ''}")
    for pred in ("needs_resize", "needs_shrink"):
        assert bool(getattr(tf, pred)(tcfg2, tstate2)) == bool(
            getattr(jf, pred)(jcfg2, jstate2)
        ), pred
    return tcfg2, tstate2


def _auto_grow(f, family, spec, chunk, keys, growth):
    """``auto_grow`` over ``growth`` times the initial capacity: the state
    after every step that changed the config, and at the end."""
    cfg, st = f.make(family, spec)
    n = growth * _initial_capacity(family, cfg)
    ks = _keys(2, n)
    seen = []
    for i in range(0, n, chunk):
        before = cfg
        cfg, st = f.auto_grow(cfg, st, keys(ks[i : i + chunk]))
        if cfg != before:
            seen.append((f"grew at {i}", cfg, st))
    seen.append(("end", cfg, st))
    probes = np.concatenate([ks[::5], _keys(3, 500, lo=2**31, hi=2**32)])
    return seen, np.asarray(f.contains(cfg, st, keys(probes)))


class _Jax:
    """``repro.filters`` with a ``make(family, spec)`` as the port's below."""

    insert, contains, grow, resize = jf.insert, jf.contains, jf.grow, jf.resize
    shrink, auto_grow = jf.shrink, jf.auto_grow
    needs_resize, needs_shrink = jf.needs_resize, jf.needs_shrink

    @staticmethod
    def make(family, spec):
        return jf.make(family, **dict(spec, backend=_jax_backend(spec)))


def _port(backend):
    class _Torch:
        insert, contains, grow, resize = tf.insert, tf.contains, tf.grow, tf.resize
        shrink, auto_grow = tf.shrink, tf.auto_grow
        needs_resize, needs_shrink = tf.needs_resize, tf.needs_shrink

        @staticmethod
        def make(family, spec):
            return tf.make(family, device="cpu", **dict(spec, backend=backend))

    return _Torch


@functools.lru_cache(maxsize=None)
def _jax_auto_grow(case):
    family, spec, chunk, growth = CASES[case]
    return _auto_grow(_Jax, family, spec, chunk, jnp.asarray, growth)


def _port_cfg(jcfg, backend):
    """The JAX side's config with the port's backend spelling."""
    return jcfg._replace(backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_grow_doubles_and_clears_predicate_matches_jax(case, backend):
    """Filled to the initial capacity, ``needs_resize`` trips; one ``grow``
    (the JAX package's on the same leaves beside it) clears it."""
    family, spec, chunk, _ = CASES[case]
    cfg0 = tf.make(family, device="cpu", **spec)[0]
    cfg, st, ks = _fill(family, spec, backend, _initial_capacity(family, cfg0), chunk)
    jcfg, jst = _to_jax(family, cfg, st)
    assert bool(tf.needs_resize(cfg, st)) and bool(jf.needs_resize(jcfg, jst))
    grown_cfg, grown = _step_as_jax(family, "grow", cfg, st)
    assert grown_cfg != cfg
    assert not bool(tf.needs_resize(grown_cfg, grown))
    assert tf.contains(grown_cfg, grown, _tkeys(ks)).all()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_grow_ingests_a_multiple_of_its_capacity_as_jax(case, backend):
    family, spec, chunk, growth = CASES[case]
    jseen, jhits = _jax_auto_grow(case)
    tseen, thits = _auto_grow(_port(backend), family, spec, chunk, _tkeys, growth)
    assert [s[0] for s in tseen] == [s[0] for s in jseen]
    assert len(tseen) >= 3  # grew at least twice on the way
    for (step, jc, js), (_, tc, ts) in zip(jseen, tseen):
        _assert_same(_port_cfg(jc, backend), js, tc, ts, step)
    np.testing.assert_array_equal(thits, jhits)
    cfg, st = tseen[-1][1:]
    s = tf.stats(cfg, st)
    cfg0 = tf.make(family, device="cpu", **spec)[0]
    assert int(s["n"]) == growth * _initial_capacity(family, cfg0)
    assert not bool(s["overflow"])
    assert thits[: -500].all()


def test_qf_auto_grow_matches_static_filter():
    """QF fingerprints are split-invariant: the grown planes equal those of
    the JAX package's filter built statically at the final size."""
    cfg, st = tf.make("qf", device="cpu", q=8, r=16, backend="pallas")
    keys = _keys(3, 8 * cfg.core.capacity)
    for i in range(0, keys.shape[0], 128):
        cfg, st = tf.auto_grow(cfg, st, _tkeys(keys[i : i + 128]))
    jcfg, jst = jf.make("qf", q=cfg.q, r=cfg.r, backend="pallas")
    jst = jf.insert(jcfg, jst, jnp.asarray(keys))
    # auto_grow's overflow and n equal the static build's; planes too
    _assert_same(jcfg, jst, cfg, st)


# explicit targets of each family's resize, from a state after 5 batches
QF = dict(q=8, r=16)
BUFFERED = dict(ram_q=7, disk_q=10, p=26)
CASCADE = dict(ram_q=7, p=26, levels=3)
FROZEN = dict(CASCADE, frozen_below=1)
RESIZES = {
    "qf new_q=q+2": ("qf", QF, dict(new_q=10)),
    "qf new_q=q-1": ("qf", QF, dict(new_q=7)),
    "buffered_qf disk_q=+2": ("buffered_qf", BUFFERED, dict(disk_q=12)),
    "buffered_qf disk_q=-1": ("buffered_qf", BUFFERED, dict(disk_q=9)),
    "cascade levels=4": ("cascade", CASCADE, dict(levels=4)),
    "cascade fanout=4": ("cascade", CASCADE, dict(fanout=4)),
    "cascade levels=2": ("cascade", CASCADE, dict(levels=2)),
    # a QF target, a frozen target peeled again, and empty frozen levels added
    "frozen cascade fanout=4": ("cascade", FROZEN, dict(fanout=4)),
    "frozen cascade levels=2": ("cascade", FROZEN, dict(levels=2)),
    "frozen cascade levels=4": ("cascade", FROZEN, dict(levels=4)),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_to_explicit_targets_matches_jax(case, backend):
    family, spec, target = RESIZES[case]
    cfg, st, ks = _fill(family, spec, backend, 5 * 48, 48)
    cfg, st = _step_as_jax(family, "resize", cfg, st, **target)
    assert tf.contains(cfg, st, _tkeys(ks)).all()
    assert int(tf.stats(cfg, st)["n"]) == 240
    assert not bool(tf.stats(cfg, st)["overflow"])


# shrink until the low watermark no longer fires: (family, spec, keys, chunk)
SHRINKS = {
    "qf": ("qf", dict(q=10, r=14), 120, 120),
    "buffered_qf": ("buffered_qf", BUFFERED, 96, 48),
    "cascade": ("cascade", CASCADE, 96, 48),
    "frozen cascade": ("cascade", FROZEN, 96, 48),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(SHRINKS))
def test_shrink_to_the_low_watermark_matches_jax(case, backend):
    family, spec, n, chunk = SHRINKS[case]
    cfg, st, ks = _fill(family, spec, backend, n, chunk)
    steps = 0
    while bool(tf.needs_shrink(cfg, st)):
        assert bool(jf.needs_shrink(*_to_jax(family, cfg, st)))
        cfg, st = _step_as_jax(family, "shrink", cfg, st)
        assert not bool(tf.needs_resize(cfg, st))  # no thrash back up
        steps += 1
    assert steps >= 1
    assert not bool(jf.needs_shrink(*_to_jax(family, cfg, st)))
    assert tf.contains(cfg, st, _tkeys(ks)).all()


@pytest.mark.parametrize("n,dq", [(1, 1), (150, 2), (300, 3)])
def test_core_grow_then_shrink_preserves_the_multiset(n, dq):
    cfg = tqf.QFConfig(q=9, r=12, slack=512)
    jcfg = jqf.QFConfig(q=9, r=12, slack=512)
    keys = _keys(40 + n, n)
    st = tqf.insert(cfg, tqf.empty(cfg, "cpu"), _tkeys(keys))
    jst = jqf.insert(jcfg, jqf.empty(jcfg), jnp.asarray(keys))
    up_cfg, up = tqf.resize(cfg, st, cfg.q + dq)
    jup_cfg, jup = jqf.resize(jcfg, jst, jcfg.q + dq)
    assert up_cfg._asdict() == jup_cfg._asdict()
    for name, a, b in zip(jup._fields, jup, up):
        np.testing.assert_array_equal(
            np.asarray(a).astype(np.int64), b.numpy().astype(np.int64), name
        )
    down_cfg, down = tqf.resize(up_cfg, up, cfg.q)
    assert down_cfg == cfg
    for name, a, b in zip(st._fields, st, down):
        assert torch.equal(a, b), name


def test_pallas_shrink_keeps_the_31_bit_remainder_limit():
    cfg, st = tf.make("qf", device="cpu", q=6, r=31, backend="pallas")
    jcfg, jst = jf.make("qf", q=6, r=31, backend="pallas")
    assert not bool(tf.needs_shrink(cfg, st)) and not bool(jf.needs_shrink(jcfg, jst))
    with pytest.raises(ValueError):
        tf.shrink(cfg, st)
    cfg, st = tf.make("qf", device="cpu", q=6, r=31)
    assert bool(tf.needs_shrink(cfg, st))
    cfg, st = tf.shrink(cfg, st)
    assert (cfg.q, cfg.r) == (5, 32)
    with pytest.raises(ValueError):
        tf.resize(cfg, st, new_q=31)
    bcfg, bst = tf.make("buffered_qf", device="cpu", ram_q=7, disk_q=8, p=26)
    with pytest.raises(ValueError):
        tf.shrink(bcfg, bst)
    with pytest.raises(ValueError):
        tf.resize(bcfg, bst, disk_q=7)
    ccfg, cst = tf.make("cascade", device="cpu", ram_q=7, p=30, fanout=4, levels=1)
    with pytest.raises(ValueError):
        tf.shrink(ccfg, cst)
    with pytest.raises(ValueError):
        tf.resize(ccfg, cst, fanout=3)


def test_overflow_flag_survives_grow_and_restream():
    """An overflowed structure stays flagged through ``grow`` and the
    cascade's restreaming ``resize``, as in the JAX package."""
    true = torch.ones((), dtype=torch.bool)
    cfg, st = tf.make("buffered_qf", device="cpu", **BUFFERED)
    st = st._replace(disk=st.disk._replace(overflow=true))
    cfg, st = _step_as_jax("buffered_qf", "grow", cfg, st)
    assert bool(tf.stats(cfg, st)["overflow"])
    for spec in (CASCADE, FROZEN):
        cfg, st = tf.make("cascade", device="cpu", **spec)
        st = st._replace(q0=st.q0._replace(overflow=true))
        cfg, st = _step_as_jax("cascade", "resize", cfg, st, fanout=4)
        assert bool(tf.stats(cfg, st)["overflow"])


def test_cascade_needs_resize_sees_q0_overshoot():
    """A batch past Q0's design capacity makes every collapse impossible;
    ``needs_resize`` takes Q0's actual count and one grow recovers."""
    spec = dict(ram_q=7, p=30, fanout=4, levels=1)
    cfg, st = tf.make("cascade", device="cpu", **spec)
    jcfg, jst = jf.make("cascade", **spec)
    big = _keys(50, 448)  # > bottom capacity 384: no collapse fits
    st = tf.insert(cfg, st, _tkeys(big))
    jst = jf.insert(jcfg, jst, jnp.asarray(big))
    assert int(st.q0.n) == 448
    assert bool(tf.needs_resize(cfg, st)) and bool(jf.needs_resize(jcfg, jst))
    cfg, st = tf.grow(cfg, st)
    jcfg, jst = jf.grow(jcfg, jst)
    more = _keys(51, 64)
    st = tf.insert(cfg, st, _tkeys(more))
    jst = jf.insert(jcfg, jst, jnp.asarray(more))
    _assert_same(jcfg, jst, cfg, st)
    assert tf.contains(cfg, st, _tkeys(big)).all()
    assert not bool(tf.stats(cfg, st)["overflow"])


def test_buffered_merge_then_grow_recovers():
    """Merging two near-full buffered QFs oversubscribes the disk level;
    ``needs_resize`` flags it and one grow restores the operating point."""
    spec = dict(ram_q=7, disk_q=10, p=26)
    cfg, sa = tf.make("buffered_qf", device="cpu", **spec)
    _, sb = tf.make("buffered_qf", device="cpu", **spec)
    ka = _keys(12, cfg.disk.capacity - 128)
    kb = _keys(13, cfg.disk.capacity - 128, lo=2**30, hi=2**31)
    for i in range(0, ka.shape[0], 64):
        sa = tf.insert(cfg, sa, _tkeys(ka[i : i + 64]))
        sb = tf.insert(cfg, sb, _tkeys(kb[i : i + 64]))
    merged = tf.merge(cfg, sa, sb)
    assert bool(tf.needs_resize(cfg, merged))
    cfg2, grown = tf.grow(cfg, merged)
    assert not bool(tf.needs_resize(cfg2, grown))
    assert tf.contains(cfg2, grown, _tkeys(ka)).all()
    assert tf.contains(cfg2, grown, _tkeys(kb)).all()
    # the JAX package's grow of the port's merged state gives the same
    jcfg, _ = jf.make("buffered_qf", **spec)
    leaves, treedef = jax.tree_util.tree_flatten(jf.make("buffered_qf", **spec)[1])
    jmerged = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in tf.to_numpy(cfg, merged)]
    )
    jcfg2, jgrown = jf.grow(jcfg, jmerged)
    _assert_same(jcfg2, jgrown, cfg2, grown)
