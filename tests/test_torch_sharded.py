"""The port's ``sharded_qf`` family against the JAX package's, bit for bit.

One stream of operations (:func:`observe`) runs through both packages
for 1, 2 and 8 shards: inserts, ``contains`` on a batch that is no
multiple of the shard count, ``merge``, ``grow``, ``resize``,
``shrink`` down the ``needs_shrink`` hysteresis, ``auto_grow`` past 8x
the initial capacity, and a skewed batch whose keys all route to shard
0 beyond the exchange's capacity.  Every step's state leaves (``rem``,
``occ``, ``shf``, ``con``, ``n``, ``overflow``, stacked per shard),
``stats``, predicates and hit masks must be equal: integer structures,
no tolerance.

The JAX package runs in one subprocess per device count (its mesh needs
``n_shards`` devices: XLA's forced host device count), all three at
once, each writing its observations to an ``.npz``.  Its ``merge``,
``grow`` and ``shrink`` fail on the state its shard_map'd insert
returns under jax 0.9.0 (``jax.vmap`` over leaves carrying a
``NamedSharding``), so its side round-trips the state through numpy
before them; the port takes the state its insert returned, as it is.
Its ``contains`` of a batch that is no multiple of two or more shards
raises there too (the slice that drops the padding), so that slice is
taken on the host.
The port's shards lie on a list of CPU devices, repeated.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from repro_torch import filters as tf
from repro_torch.core import fingerprint as tfp
from repro_torch.core import quotient_filter as tqf
from repro_torch.filters import sharded as tsh

from tests.test_distributed import run_with_devices

SPECS = {
    1: dict(q=12, r=10, n_shards=1),
    2: dict(q=12, r=10, n_shards=2),
    8: dict(q=14, r=12, n_shards=8),
}
BATCH = 512
PROBES = 1001  # no multiple of 2 or 8: contains pads its batch
STEPS = ("insert", "contains", "merge", "grow", "resize", "shrink", "auto_grow",
         "skewed")


def _keys(seed, n, hi=2**32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, size=n, dtype=np.int64).astype(np.uint32)


def _probes():
    """One probe set for every state (one lookup compile a config on the
    JAX side): the base stream's every third key, keys of the merged
    and the shrunk filters, fresh keys."""
    held = [_keys(1, 2 * BATCH)[::3], _keys(4, BATCH)[:100]]
    held.append(_keys(7, 512, hi=2**31)[:100])
    n_held = sum(a.shape[0] for a in held)
    return np.concatenate(held + [_keys(2, PROBES - n_held)])


class _Port:
    """The port's façade, shards on a list of CPU devices."""

    def __init__(self, n):
        self.devices = ["cpu"] * n

    def make(self, spec):
        return tf.make("sharded_qf", device=self.devices, **spec)

    @staticmethod
    def keys(a):
        return torch.from_numpy(a.view(np.int32).copy())

    @staticmethod
    def leaves(cfg, st):
        return tf.to_numpy(cfg, st)

    @staticmethod
    def owner_bits(keys, cfg):
        fq, _ = tfp.fingerprint(torch.from_numpy(keys.astype(np.int64)), cfg.q, cfg.r)
        return fq.numpy() >> (cfg.q - cfg.core.shard_bits)

    insert, contains, stats = map(staticmethod, (tf.insert, tf.contains, tf.stats))
    merge, grow, shrink, auto_grow = map(
        staticmethod, (tf.merge, tf.grow, tf.shrink, tf.auto_grow)
    )
    needs_resize, needs_shrink = map(staticmethod, (tf.needs_resize, tf.needs_shrink))

    @staticmethod
    def resize(cfg, st, new_q):
        return tf.resize(cfg, st, new_q=new_q)


class _Jax:
    """The JAX package's façade; merge, grow and shrink take the state
    through numpy first (the reference's fault under jax 0.9.0)."""

    def __init__(self, n):
        import jax
        import jax.numpy as jnp

        from repro import filters as jf
        from repro.core import fingerprint as jfp

        self.jax, self.jnp, self.jf, self.jfp = jax, jnp, jf, jfp
        self.insert, self.stats = jf.insert, jf.stats
        self.needs_resize, self.needs_shrink = jf.needs_resize, jf.needs_shrink

    def make(self, spec):
        return self.jf.make("sharded_qf", **spec)

    def keys(self, a):
        return self.jnp.asarray(a)

    def leaves(self, cfg, st):
        return [np.asarray(x) for x in self.jax.tree_util.tree_leaves(st)]

    def owner_bits(self, keys, cfg):
        fq, _ = self.jfp.fingerprint(self.jnp.asarray(keys), cfg.q, cfg.r)
        return np.asarray(fq) >> (cfg.q - cfg.core.shard_bits)

    def contains(self, cfg, st, keys):
        """``repro.filters.contains`` with its padding cut on the host: under
        jax 0.9.0 its slice of the sharded hits raises (a ragged batch on
        two or more shards)."""
        pad = (-keys.shape[0]) % cfg.n_shards
        padded = self.jnp.concatenate([keys, keys[:1].repeat(pad)]) if pad else keys
        return np.asarray(self.jf.contains(cfg, st, padded))[: keys.shape[0]]

    def host(self, st):
        return self.jax.tree.map(lambda x: self.jnp.asarray(np.asarray(x)), st)

    def merge(self, cfg, a, b):
        return self.jf.merge(cfg, self.host(a), self.host(b))

    def grow(self, cfg, st):
        return self.jf.grow(cfg, self.host(st))

    def resize(self, cfg, st, new_q):
        return self.jf.resize(cfg, self.host(st), new_q=new_q)

    def shrink(self, cfg, st):
        return self.jf.shrink(cfg, self.host(st))

    def auto_grow(self, cfg, st, keys, max_steps=32):
        """``repro.filters.auto_grow``, its grow steps through :meth:`grow`."""

        def settle(cfg, st):
            for _ in range(max_steps):
                if not bool(self.needs_resize(cfg, st)):
                    return cfg, st
                cfg, st = self.grow(cfg, st)
            raise RuntimeError("still over capacity")

        cfg, st = settle(cfg, st)
        return settle(cfg, self.insert(cfg, st, keys))


def observe(side, n) -> dict:
    """Run the test stream through one package; every observation as numpy."""
    obs = {}

    def state(label, cfg, st):
        obs[f"{label}/cfg"] = np.array([cfg.q, cfg.r, cfg.n_shards])
        for i, a in enumerate(side.leaves(cfg, st)):
            obs[f"{label}/leaf{i}"] = np.asarray(a)
        for k, v in side.stats(cfg, st).items():
            obs[f"{label}/stats/{k}"] = np.asarray(v)

    def hits(label, cfg, st, keys):
        obs[f"{label}/hits"] = np.asarray(side.contains(cfg, st, side.keys(keys)))

    spec = SPECS[n]
    base = _keys(1, 2 * BATCH)
    probes = _probes()

    cfg, st = side.make(spec)
    for i in range(2):
        st = side.insert(cfg, st, side.keys(base[i * BATCH : (i + 1) * BATCH]))
        state(f"insert/{i}", cfg, st)
    hits("contains/probes", cfg, st, probes)

    _, other = side.make(spec)
    other = side.insert(cfg, other, side.keys(_keys(4, BATCH)))
    merged = side.merge(cfg, st, other)
    state("merge", cfg, merged)
    hits("merge", cfg, merged, probes)

    obs["grow/needs_resize_before"] = np.asarray(side.needs_resize(cfg, st))
    gcfg, gst = side.grow(cfg, st)
    state("grow", gcfg, gst)
    hits("grow", gcfg, gst, probes)
    obs["grow/needs_resize"] = np.asarray(side.needs_resize(gcfg, gst))

    rcfg, rst = side.resize(cfg, st, spec["q"] + 2)
    state("resize", rcfg, rst)
    hits("resize", rcfg, rst, probes)

    # down the hysteresis from the test_incremental case's 512 keys
    small = _keys(7, 512, hi=2**31)
    scfg, sst = side.make(spec)
    sst = side.insert(scfg, sst, side.keys(small))
    step = 0
    while True:
        flag = bool(side.needs_shrink(scfg, sst))
        obs[f"shrink/{step}/needs_shrink"] = np.asarray(flag)
        if not flag:
            break
        scfg, sst = side.shrink(scfg, sst)
        state(f"shrink/{step}", scfg, sst)
        hits(f"shrink/{step}", scfg, sst, probes)
        step += 1
    if n > 1:  # the loaded filter halves too: the predicate is no gate
        hcfg, hst = side.shrink(cfg, st)
        state("shrink/loaded", hcfg, hst)
        hits("shrink/loaded", hcfg, hst, probes)

    acfg, ast = side.make(spec)
    cap0 = tsh.ShardedQFilterConfig(**spec).core.local_cfg.capacity * n
    stream = _keys(2, 8 * cap0 + (-8 * cap0) % BATCH)
    for i in range(0, stream.shape[0], BATCH):
        acfg, ast = side.auto_grow(acfg, ast, side.keys(stream[i : i + BATCH]))
    state("auto_grow", acfg, ast)
    obs["auto_grow/all_hit"] = np.asarray(
        bool(np.asarray(side.contains(acfg, ast, side.keys(stream))).all())
    )

    # every key routes to shard 0: past the exchange's capacity rows drop
    pool = _keys(9, 64 * BATCH)
    skewed = pool[side.owner_bits(pool, cfg) == 0][:BATCH]
    kcfg, kst = side.make(spec)
    kst = side.insert(kcfg, kst, side.keys(skewed))
    state("skewed", kcfg, kst)
    hits("skewed", kcfg, kst, np.concatenate([skewed, probes[: PROBES - BATCH]]))
    return obs


def jax_observations(n) -> dict:
    """The JAX side's stream, then a port state carried into the JAX
    package as its stacked leaves and probed and inserted into there."""
    import jax

    side = _Jax(n)
    obs = observe(side, n)
    spec = SPECS[n]
    base = _keys(1, 2 * BATCH)
    jcfg, jst = side.make(spec)
    treedef = jax.tree_util.tree_structure(jst)
    tcfg, tst = _Port(n).make(spec)
    tst = tf.insert(tcfg, tst, _Port.keys(base[:BATCH]))
    carried = jax.tree_util.tree_unflatten(
        treedef, [side.jnp.asarray(a) for a in tf.to_numpy(tcfg, tst)]
    )
    obs["carried/hits"] = np.asarray(side.contains(jcfg, carried, side.keys(base)))
    carried = side.insert(jcfg, carried, side.keys(base[BATCH:]))
    for i, a in enumerate(side.leaves(jcfg, carried)):
        obs[f"carried/leaf{i}"] = a
    return obs


@pytest.fixture(scope="module")
def jax_obs(tmp_path_factory):
    """Each device count's JAX observations, the three subprocesses at once."""
    out = tmp_path_factory.mktemp("sharded_jax")

    def run(n):
        path = out / f"jax_{n}.npz"
        run_with_devices(
            "import numpy as np\n"
            "from tests.test_torch_sharded import jax_observations\n"
            f"np.savez({str(path)!r}, **jax_observations({n}))\n",
            n_devices=n,
        )
        with np.load(path) as z:
            return n, dict(z)

    with concurrent.futures.ThreadPoolExecutor(len(SPECS)) as pool:
        return dict(pool.map(run, SPECS))


@functools.lru_cache(maxsize=None)
def _port_obs(n):
    return observe(_Port(n), n)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("n", sorted(SPECS))
def test_step_matches_jax(jax_obs, n, step):
    jo = {k: v for k, v in jax_obs[n].items() if k.split("/")[0] == step}
    to = {k: v for k, v in _port_obs(n).items() if k.split("/")[0] == step}
    assert jo and sorted(to) == sorted(jo)
    for k, a in jo.items():
        b = to[k]
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_stream_sees_what_it_claims(jax_obs):
    """The stream reaches the cases it is meant to: shrink steps, growth,
    no overflow, and drops in the skewed batch."""
    for n, obs in jax_obs.items():
        assert obs["auto_grow/all_hit"] and not obs["auto_grow/stats/overflow"]
        assert obs["auto_grow/cfg"][0] == SPECS[n]["q"] + 4, n  # 8x at load 0.75
        assert obs["insert/1/stats/n"] == 2 * BATCH
        assert obs["merge/stats/n"] == 3 * BATCH
        n_base = (2 * BATCH + 2) // 3  # the probes: base, merged, shrunk keys
        assert obs["contains/probes/hits"][:n_base].all()
        assert obs["merge/hits"][: n_base + 100].all()
        assert obs["shrink/loaded/hits" if n > 1 else "grow/hits"][:n_base].all()
        if n > 1:
            assert obs["shrink/0/hits"][n_base + 100 : n_base + 200].all()
        assert not obs["grow/needs_resize"]
        # past the exchange's capacity the insert drops rows and the
        # lookup drops queries (a miss), in both packages
        n_skew_hit = int(obs["skewed/hits"][:BATCH].sum())
        if n == 1:
            assert n_skew_hit == obs["skewed/stats/n"] == BATCH
        else:
            assert n_skew_hit < obs["skewed/stats/n"] < BATCH
    # the test_incremental case: one shrink, then the halved threshold holds
    assert jax_obs[2]["shrink/0/cfg"].tolist() == [11, 11, 1]
    assert not jax_obs[2]["shrink/1/needs_shrink"]
    assert jax_obs[8]["shrink/1/cfg"].tolist() == [12, 14, 2]
    assert not jax_obs[1]["shrink/0/needs_shrink"]


@pytest.mark.parametrize("n", sorted(SPECS))
def test_numpy_carry_both_ways(jax_obs, n):
    spec = SPECS[n]
    base = _keys(1, 2 * BATCH)
    cfg, _ = tf.make("sharded_qf", device="cpu" if n == 1 else ["cpu"] * n, **spec)
    # JAX leaves into the port: the same state, the same answers
    jax_leaves = [jax_obs[n][f"insert/1/leaf{i}"] for i in range(6)]
    st = tf.from_numpy(cfg, jax_leaves, device=["cpu"] * n)
    assert [s.rem.device.type for s in st] == ["cpu"] * n
    for a, b in zip(jax_leaves, tf.to_numpy(cfg, st)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tf.contains(cfg, st, _Port.keys(_probes())).numpy(),
        jax_obs[n]["contains/probes/hits"],
    )
    # port leaves into the JAX package: its probes and its next insert
    # agree with the port's
    _, tst = tsh.make(device=["cpu"] * n, **spec)
    tst = tf.insert(cfg, tst, _Port.keys(base[:BATCH]))
    np.testing.assert_array_equal(
        jax_obs[n]["carried/hits"], tf.contains(cfg, tst, _Port.keys(base)).numpy()
    )
    tst = tf.insert(cfg, tst, _Port.keys(base[BATCH:]))
    for i, a in enumerate(tf.to_numpy(cfg, tst)):
        np.testing.assert_array_equal(jax_obs[n][f"carried/leaf{i}"], a)
    with pytest.raises(ValueError):
        tf.from_numpy(cfg, jax_leaves[:-1], device=["cpu"] * n)


def _global_stream(cfg, state):
    """Every shard's sorted fingerprints, quotients offset by the shard."""
    local = cfg.core.local_cfg
    qs, rs = [], []
    for s, st in enumerate(state):
        fq, fr, n = tqf.extract(local, st)
        qs.append(fq[: int(n)] + (s << local.q))
        rs.append(fr[: int(n)])
    return torch.cat(qs), torch.cat(rs)


def _flat_stream(cfg, st):
    fq, fr, n = tqf.extract(cfg.core, st)
    return fq[: int(n)], fr[: int(n)]


@pytest.mark.parametrize("n", sorted(SPECS))
def test_holds_the_fingerprints_of_a_flat_qf(n):
    """Shards hold a flat ``qf``'s stream, split by quotient prefix, and
    answer its membership, through grow and shrink as well."""
    spec = SPECS[n]
    keys = _Port.keys(_keys(1, 2 * BATCH))
    probes = _Port.keys(np.concatenate([_keys(1, 2 * BATCH), _keys(3, 2000)]))
    cfg, st = tf.make("sharded_qf", device=["cpu"] * n, **spec)
    st = tf.insert(cfg, st, keys)
    fcfg, fst = tf.make("qf", device="cpu", q=spec["q"], r=spec["r"])
    fst = tf.insert(fcfg, fst, keys)
    pairs = [(cfg, st, fcfg, fst), (*tf.grow(cfg, st), *tf.grow(fcfg, fst))]
    if n > 1:
        pairs.append((*tf.shrink(cfg, st), *tf.shrink(fcfg, fst)))
    for scfg, sst, qcfg, qst in pairs:
        for a, b in zip(_global_stream(scfg, sst), _flat_stream(qcfg, qst)):
            assert torch.equal(a, b), (scfg, qcfg)
        assert torch.equal(
            tf.contains(scfg, sst, probes), tf.contains(qcfg, qst, probes)
        )


def test_merge_grow_shrink_take_the_state_insert_returned():
    """The reference's fault, pinned on its smallest input: under jax
    0.9.0 its merge of a ``sharded_qf(q=12, r=10, n_shards=1)`` that
    took 512 keys raises (``Resource axis: data ... is not found in
    mesh``) unless the state goes through numpy first.  The port's
    merge, grow and shrink take the state its insert returned."""
    keys = _Port.keys(_keys(7, 512, hi=2**31))
    cfg, st = tf.make("sharded_qf", device="cpu", q=12, r=10, n_shards=1)
    st = tf.insert(cfg, st, keys)
    merged = tf.merge(cfg, st, st)
    assert int(tf.stats(cfg, merged)["n"]) == 1024
    gcfg, gst = tf.grow(cfg, st)
    assert int(tf.stats(gcfg, gst)["n"]) == 512
    cfg2, st2 = tf.make("sharded_qf", device=["cpu"] * 2, q=12, r=10, n_shards=2)
    st2 = tf.insert(cfg2, st2, keys)
    hcfg, hst = tf.shrink(cfg2, st2)
    assert (hcfg.q, hcfg.r, hcfg.n_shards) == (11, 11, 1)
    for c, s in ((cfg, merged), (gcfg, gst), (hcfg, hst)):
        assert bool(tf.contains(c, s, keys).all())


def test_refuses_what_the_reference_refuses(monkeypatch):
    cfg, st = tf.make("sharded_qf", device=["cpu"] * 2, q=10, r=10, n_shards=2)
    keys = _Port.keys(_keys(1, 64))
    with pytest.raises(NotImplementedError):
        tf.insert(cfg, st, keys, k=32)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        tf.insert(cfg, st, keys[:63])
    with pytest.raises(ValueError, match="power of two"):
        tf.make("sharded_qf", device=["cpu"] * 3, q=10, r=10, n_shards=3)
    with pytest.raises(ValueError, match="one device holds one shard"):
        tf.make("sharded_qf", device="cpu", q=10, r=10, n_shards=2)
    with pytest.raises(ValueError):
        tf.make("sharded_qf", device=["cpu"] * 3, q=10, r=10, n_shards=2)
    with pytest.raises(ValueError, match="all on the CPU"):
        tf.make("sharded_qf", device=["cpu", "cuda:0"], q=10, r=10, n_shards=2)
    with pytest.raises(NotImplementedError):
        tf.resize(cfg, st, new_q=9)
    with pytest.raises(ValueError, match="cannot halve"):
        tf.shrink(*tf.make("sharded_qf", device="cpu", q=10, r=10))
    with pytest.raises(ValueError, match="exhausted"):
        tf.grow(*tf.make("sharded_qf", device="cpu", q=10, r=1))
    assert not tf.supports("sharded_qf", "delete")
    # device=None: shard s on cuda:s, so n_shards must divide the card count
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="does not divide"):
        tf.make("sharded_qf", q=10, r=10, n_shards=2)
    assert tsh.shard_devices(1) == [torch.device("cuda", 0)]
