"""The port's SSM / RG-LRU / encoder-decoder serving path against the JAX
package on the CPU: ``layers.conv1d_causal``, ``models/ssm.py``,
``models/rglru.py``, the ``ssm``/``rec``/``xattn`` sub-blocks, the
remainder layers (``tail_{i}``), the encoder and the learned positions.

The three architectures (mamba2-130m, recurrentgemma-9b,
whisper-large-v3) run under ``make_smoke`` (float32) with the JAX
package's ``model.init(cfg, 0)`` carried across by ``model.from_numpy``.
RecurrentGemma's smoke config has one (rec, rec, attn) unit and a
remainder ``rec`` layer, and at S = 40 its attention ring (window 32)
wraps; whisper takes frames from the same numpy seed, and runs past its
smoke ``max_seq`` of 128, where both packages read the last row of the
position table.  Integer results are exact (greedy tokens, ``kpos``,
``pos``); float results are held to

    max |port - jax| / max |jax|  <  RTOL = 1e-4

(float32: the scans sum in other orders than XLA's trees).
RecurrentGemma's leaves are first brought to their true fan-in
(``at_true_fan_in``, as ``chip_smoke.py`` does at full width): ``init``
takes a stacked leaf's fan-in from its layer axis, 1 in the smoke config,
so its RG-LRU gates saturate, a_t comes within float32 rounding of 1, and
sqrt(1 - a_t^2) turns a last-bit difference of a_t into about 1e-4 of the
state within four decode steps; both packages then sit about 1e-4 from
a float64 run, and from each other.  The mixers and
the conv also run on bfloat16 leaves and activations, held to
``BF16_RTOL`` = 2^-6, so the reference's cast points are kept.  Each JAX
model job runs once, in a thread of its own started with the first test
that needs one, and is shared by its tests.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as trglru
from repro_torch.models import schema as tschema
from repro_torch.models import ssm as tssm

RTOL = 1e-4
BF16_RTOL = 2**-6
ARCHS = ["mamba2-130m", "recurrentgemma-9b", "whisper-large-v3"]
B, S, STEPS = 2, 40, 4
CLAMP_S = 126  # whisper's prefill that decodes past its smoke max_seq of 128
LONG_S = 130  # whisper's forward past it
DTYPES = ["float32", "bfloat16"]


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def cpu(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def smoke(name):
    return (jconfigs.make_smoke(jconfigs.get_config(name)),
            tconfigs.make_smoke(tconfigs.get_config(name)))


def make_batch(cfg, seq: int, seed: int = 7) -> dict:
    """Tokens (B, seq) and, for whisper, frames (B, encoder_seq, d), numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# The JAX side of the three models, a thread a job
# ---------------------------------------------------------------------------

JOBS = {name: (name, S) for name in ARCHS}
JOBS["whisper-clamp"] = ("whisper-large-v3", CLAMP_S)


@functools.cache
def _jax_jobs():
    pool = ThreadPoolExecutor(len(JOBS))
    return {job: pool.submit(_jax_side, *args) for job, args in JOBS.items()}


def jax_side(job):
    return _jax_jobs()[job].result()


def _jax_side(name, seq):
    """The JAX package's forward, prefill and greedy decode at (B, seq),
    each jitted as the reference's serving driver jits them."""
    cfg = jconfigs.make_smoke(jconfigs.get_config(name))
    params = jmodel.init(cfg, 0)
    if name == "recurrentgemma-9b":
        params = at_true_fan_in(tconfigs.make_smoke(tconfigs.get_config(name)), params)
    batch = make_batch(cfg, seq)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    forward = jax.jit(lambda p, b: jmodel.forward(p, cfg, b, remat=False)[0])
    decode = jax.jit(lambda p, c, t: jmodel.decode_step(p, cfg, c, t))
    logits = forward(params, jbatch)
    last, cache = jax.jit(lambda p, b: jmodel.prefill(p, cfg, b, remat=False))(params, jbatch)
    out = {
        "params": jax_tree(params),
        "batch": batch,
        "logits": np.asarray(logits),
        "last": np.asarray(last),
        "cache": jax_tree(cache),
    }
    tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    steps = []
    for _ in range(STEPS):
        lg, cache = decode(params, cache, tok)
        tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        steps.append((np.asarray(lg), np.asarray(tok)))
    out["steps"] = steps
    out["decoded"] = jax_tree(cache)
    if cfg.is_encoder_decoder and seq == CLAMP_S:
        long = make_batch(cfg, LONG_S, seed=8)
        out["long"] = long
        out["long_logits"] = np.asarray(forward(params, {k: jnp.asarray(v) for k, v in long.items()}))
    return out


def at_true_fan_in(cfg, params):
    """The params with each leaf that ``init`` draws at 1/sqrt(fan_in)
    rescaled to the fan-in of its product: the first axis that is neither
    ``layers`` nor ``experts``."""
    flat = dict(tschema.tree_items(jax_tree(params)))
    for path, p in tschema.tree_items(tmodel.schema(cfg)):
        if p.init == "fan_in" and p.scale is None:
            fan_in = next(n for n, a in zip(p.shape, p.axes) if a not in ("layers", "experts"))
            flat[path] = flat[path] * np.float32(np.sqrt(p.shape[0] / fan_in))
    out = {}
    for path, leaf in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(leaf)
    return out


def port_side(job):
    ref = jax_side(job)
    cfg = tconfigs.make_smoke(tconfigs.get_config(JOBS[job][0]))
    params = tmodel.from_numpy(cfg, ref["params"], device="cpu")
    return cfg, params, ref, {k: torch.from_numpy(v) for k, v in ref["batch"].items()}


def check_cache(got, want, path=()):
    """Every leaf: states, conv windows and K/V within tolerance; kpos and
    pos exact."""
    assert sorted(got) == sorted(want), path
    for key in want:
        if isinstance(want[key], dict):
            check_cache(got[key], want[key], path + (key,))
        elif key in ("kpos", "pos"):
            np.testing.assert_array_equal(cpu(got[key]), want[key])
            assert got[key].dtype == torch.int32
        else:
            assert rel_err(cpu(got[key]), want[key]) < RTOL, path + (key,)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(name):
    cfg, params, ref, batch = port_side(name)
    logits, _, aux = tmodel.forward(params, cfg, batch)
    assert rel_err(cpu(logits), ref["logits"]) < RTOL
    assert float(aux) == 0.0


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_jax(name):
    """The last logits and every cache leaf: recurrentgemma's wrapped ring of
    32 slots and its ``tail_0`` state, whisper's self ring and cross K/V."""
    cfg, params, ref, batch = port_side(name)
    last, cache = tmodel.prefill(params, cfg, batch)
    assert rel_err(cpu(last), ref["last"]) < RTOL
    check_cache(cache, ref["cache"])
    if name == "recurrentgemma-9b":
        assert "tail_0" in cache and cache["layers"]["b2"]["attn"]["kpos"].shape[-1] == 32
        assert int(cache["layers"]["b2"]["attn"]["kpos"].min()) == S - 32  # wrapped


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_decode_matches_jax(name):
    cfg, params, ref, batch = port_side(name)
    last, cache = tmodel.prefill(params, cfg, batch)
    tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    for want_logits, want_tok in ref["steps"]:
        logits, cache = tmodel.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        assert rel_err(cpu(logits), want_logits) < RTOL
        np.testing.assert_array_equal(cpu(tok), want_tok)
    check_cache(cache, ref["decoded"])


def test_whisper_positions_clamp_at_max_seq():
    """Past the position table (smoke ``max_seq`` 128) both packages read its
    last row: a forward over 130 positions, and decode steps at positions
    126 to 129 after a prefill of 126."""
    cfg, params, ref, batch = port_side("whisper-clamp")
    long = {k: torch.from_numpy(v) for k, v in ref["long"].items()}
    assert long["tokens"].shape[1] > cfg.max_seq
    logits, _, _ = tmodel.forward(params, cfg, long)
    assert rel_err(cpu(logits), ref["long_logits"]) < RTOL
    last, cache = tmodel.prefill(params, cfg, batch)
    assert rel_err(cpu(last), ref["last"]) < RTOL
    tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    for want_logits, want_tok in ref["steps"]:
        logits, cache = tmodel.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        assert rel_err(cpu(logits), want_logits) < RTOL
        np.testing.assert_array_equal(cpu(tok), want_tok)
    assert int(cache["pos"]) == CLAMP_S + STEPS > cfg.max_seq
    check_cache(cache, ref["decoded"])


@pytest.mark.parametrize("name", ARCHS)
def test_init_cache_matches_jax(name):
    """The empty cache leaf for leaf: the ssm and rec states and conv
    windows, the tail layer's, whisper's self and cross caches."""
    jcfg, tcfg = smoke(name)
    want = dict(tschema.tree_items(jax_tree(jmodel.init_cache(jcfg, B, 40))))
    got = dict(tschema.tree_items(tmodel.init_cache(tcfg, B, 40, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert str(got[path].dtype) == f"torch.{w.dtype}", path
        np.testing.assert_array_equal(cpu(got[path]), w.astype(np.float32))


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_full_forward(name):
    """The port alone: prefill S and decode the next token against ``forward``
    over S + 1."""
    _, cfg = smoke(name)
    params = tmodel.init(cfg, 0, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in make_batch(cfg, S + 1, seed=2).items()}
    part = dict(full, tokens=full["tokens"][:, :S])
    logits, _, _ = tmodel.forward(params, cfg, full)
    last, cache = tmodel.prefill(params, cfg, part)
    step, cache = tmodel.decode_step(params, cfg, cache, full["tokens"][:, S:])
    assert rel_err(cpu(last), cpu(logits[:, S - 1])) < RTOL
    assert rel_err(cpu(step), cpu(logits[:, S])) < RTOL
    assert int(cache["pos"]) == S + 1


# ---------------------------------------------------------------------------
# The mixers and the conv, float32 and bfloat16
# ---------------------------------------------------------------------------


def leaves(sch, rng):
    """Random leaves of a sub-block schema's shapes: products at
    1/sqrt(fan-in), fixed leaves at their value with some noise."""
    out = {}
    for key, p in sch.items():
        if p.init in ("const", "ones", "zeros"):
            base = {"const": p.scale, "ones": 1.0, "zeros": 0.0}[p.init]
            out[key] = base + 0.1 * rng.normal(size=p.shape)
        else:
            out[key] = rng.normal(size=p.shape) * (p.scale or p.shape[0] ** -0.5)
    return {key: v.astype(np.float32) for key, v in out.items()}


def casts(dtype):
    def to_jax(a):
        return jnp.asarray(a).astype(dtype) if a.dtype == np.float32 else jnp.asarray(a)

    def to_torch(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(getattr(torch, dtype)) if t.dtype == torch.float32 else t

    return to_jax, to_torch


def check(got, want, dtype):
    """One result: the reference's dtype, within the dtype's tolerance."""
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = RTOL if dtype == "float32" else BF16_RTOL
    assert rel_err(cpu(got), np.asarray(want.astype(jnp.float32))) < tol


@pytest.mark.parametrize("path", ["prefill", "step"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1d_causal_matches_jax(dtype, path):
    """The prefill returns the last K - 1 inputs as its cache; the step
    slides the window by one."""
    rng = np.random.default_rng(21)
    K, C = 4, 24
    x = rng.normal(size=(B, 1 if path == "step" else 10, C)).astype(np.float32)
    w = rng.normal(size=(K, C)).astype(np.float32) * 0.5
    b = rng.normal(size=(C,)).astype(np.float32)
    c = rng.normal(size=(B, K - 1, C)).astype(np.float32) if path == "step" else None
    to_jax, to_torch = casts(dtype)

    def run(m, a):
        return m.conv1d_causal(a(x), a(w), a(b), cache=None if c is None else a(c))

    want_y, want_c = run(jlayers, to_jax)
    got_y, got_c = run(tlayers, to_torch)
    check(got_y, want_y, dtype)
    np.testing.assert_array_equal(cpu(got_c), np.asarray(want_c.astype(jnp.float32)))


@pytest.mark.parametrize("seq", [32, 24, 8])  # chunk multiple, padded, shorter than a chunk
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_block_matches_jax(dtype, seq):
    """``ssm_block``'s chunked prefill (chunk 16) with its final state and
    conv window, then a decode step from them: its output, new state and
    window."""
    jcfg, tcfg = smoke("mamba2-130m")
    rng = np.random.default_rng(22)
    p = leaves(tmodel._ssm_schema(tcfg), rng)
    x = rng.normal(size=(B, seq, tcfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    to_jax, to_torch = casts(dtype)
    jp = {k: to_jax(v) for k, v in p.items()}
    tp = {k: to_torch(v) for k, v in p.items()}

    block = jax.jit(lambda p, x, cache=None: jssm.ssm_block(p, x, jcfg, cache=cache))
    want, _, wst = block(jp, to_jax(x))
    got, none, gst = tssm.ssm_block(tp, to_torch(x), tcfg)
    assert none is None
    check(got, want, dtype)
    check(gst["state"], wst["state"], dtype)
    check(gst["conv"], wst["conv"], dtype)  # the in_proj's products: summed in another order

    want1, wc, _ = block(jp, to_jax(x1), wst)
    got1, gc, _ = tssm.ssm_block(tp, to_torch(x1), tcfg, cache=gst)
    check(got1, want1, dtype)
    check(gc["state"], wc["state"], dtype)
    check(gc["conv"], wc["conv"], dtype)


@pytest.mark.parametrize("path", ["scan", "scan_h0", "step"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rg_lru_matches_jax(dtype, path):
    """``_rg_lru``'s doubling scan over 40 positions, from zero and from a
    state ``h0``, and its one-position step."""
    _, tcfg = smoke("recurrentgemma-9b")
    rng = np.random.default_rng(23)
    p = leaves(tmodel._rec_schema(tcfg), rng)
    x = rng.normal(size=(B, 1 if path == "step" else S, tcfg.lru_width)).astype(np.float32)
    h0 = None if path == "scan" else rng.normal(size=(B, tcfg.lru_width)).astype(np.float32)
    to_jax, to_torch = casts(dtype)

    def run(m, a):
        return m._rg_lru({k: a(v) for k, v in p.items()}, a(x), None if h0 is None else a(h0))

    want_y, want_h = run(jrglru, to_jax)
    got_y, got_h = run(trglru, to_torch)
    check(got_y, want_y, dtype)
    check(got_h, want_h, dtype)


@pytest.mark.parametrize("path", ["prefill", "step"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_recurrent_block_matches_jax(dtype, path):
    """The Griffin block: its prefill's output, state and conv window, and a
    decode step from a cache."""
    jcfg, tcfg = smoke("recurrentgemma-9b")
    rng = np.random.default_rng(24)
    p = leaves(tmodel._rec_schema(tcfg), rng)
    w = tcfg.lru_width
    x = rng.normal(size=(B, 1 if path == "step" else S, tcfg.d_model)).astype(np.float32)
    cache = None
    if path == "step":
        cache = {"conv": rng.normal(size=(B, 3, w)).astype(np.float32),
                 "state": rng.normal(size=(B, w)).astype(np.float32)}
    to_jax, to_torch = casts(dtype)

    def run(m, cfg, a):
        c = None if cache is None else {k: a(v) for k, v in cache.items()}
        return m.recurrent_block({k: a(v) for k, v in p.items()}, a(x), cfg, cache=c)

    want, wc, wst = run(jrglru, jcfg, to_jax)
    got, gc, gst = run(trglru, tcfg, to_torch)
    check(got, want, dtype)
    check(gst["state"], wst["state"], dtype)
    check(gst["conv"], wst["conv"], dtype)
    assert (gc is None) == (wc is None)
