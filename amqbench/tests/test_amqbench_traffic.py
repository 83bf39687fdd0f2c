"""The traffic mixes: their files, their kinds found by name, and batches
that repeat from a seed."""

import json

import pytest
import torch

from amqbench import kinds
from amqbench.harness import spec, traffic
from amqbench.harness.traffic import Traffic
from amqbench.kinds import ingest, lookup

MIXES = sorted((spec.BENCH / "traffic").glob("*.json"))
BIG = 2**31 + 12345


def small(params):
    """The mix's parameters, at sizes the CPU holds."""
    out = dict(params, batch_keys=64, prefill_batch_keys=32,
               prefill_keys=96 if params["prefill_keys"] or params["kind"] == "lookup" else 0)
    if params["kind"] == "lookup":
        out["pool_batches"] = min(params["pool_batches"], 8)
    return out


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_mix_is_valid(path):
    params = json.loads(path.read_text())
    assert kinds.validate(params) is params


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_batches_repeat_from_a_seed(path):
    params = small(json.loads(path.read_text()))
    a, b, c = (Traffic(params, s, "cpu") for s in (BIG, BIG, BIG + 1))
    for x, y, z in ((a.prefill_batches(), b.prefill_batches(), c.prefill_batches()),):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
        assert not any(torch.equal(u, w) for u, w in zip(x, z))
    if params["kind"] == "ingest":
        assert torch.equal(ingest.batch(a, 3), ingest.batch(b, 3))
        assert not torch.equal(ingest.batch(a, 3), ingest.batch(a, 4))
        assert not torch.equal(ingest.batch(a, 3), ingest.batch(c, 3))
    else:
        members = torch.cat(a.prefill_batches())
        qa, da = lookup.pool(a, members)
        qb, db = lookup.pool(b, members)
        qc, _ = lookup.pool(c, members)
        assert torch.equal(qa, qb) and torch.equal(da, db) and not torch.equal(qa, qc)
        assert qa.shape == (params["pool_batches"], params["batch_keys"])
        k = round(params["member_share"] * params["batch_keys"])
        assert (da.sum(dim=1) == k).all()
        assert torch.isin(qa[da], members).all()
        assert not torch.equal(qa[0], qa[1])


def test_batches_differ_between_their_places():
    t = Traffic(small(json.loads(MIXES[0].read_text())), 7, "cpu")
    assert not torch.equal(t.prefill_batch(0), ingest.batch(t, 0))


def test_stream_seeds_take_any_whole_seed():
    seeds = {traffic.stream_seed(s, 1, 0) for s in (0, 1, 2**31, 2**31 + 1, 2**40, 2**63)}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)


@pytest.mark.parametrize("name", ["ingest", "lookup"])
def test_kinds_are_found_by_name(name):
    mod = kinds.module(name)
    assert mod.OP in ("insert", "probe")
    assert all(callable(getattr(mod, f)) for f in ("setup", "window", "expect"))


LOOKUP = dict(kind="lookup", prefill_keys=8, prefill_batch_keys=8, batch_keys=8, in_flight=1,
              member_share=0.5, pool_batches=1, warmup_calls=1, answers="count", sample_calls=1)


@pytest.mark.parametrize("bad", [{"kind": "scan"}, {"kind": "ingest"}, {"kind": "../run"},
                                 {"kind": None}, dict(LOOKUP, prefill_keys=0),
                                 dict(LOOKUP, member_share=1.5), dict(LOOKUP, in_flight=0),
                                 dict(LOOKUP, answers="some"),
                                 dict(LOOKUP, prefill_keys=12)])
def test_bad_mixes_are_refused(bad):
    with pytest.raises(ValueError):
        kinds.validate(bad)
