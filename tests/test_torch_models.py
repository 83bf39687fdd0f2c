"""The port's LLM skeleton (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package on the CPU.

The seven decoder architectures (the five GQA ones, and
the MoE ones: DeepSeek-V2-Lite with MLA and a leading dense layer, Grok-1
with GQA) run under ``make_smoke`` (float32) with the JAX package's
``model.init(cfg, 0)`` carried across by ``model.from_numpy``, so both
packages hold the same weights.  Integer results are exact: greedy
tokens, ``kpos``, ``pos``, the routers' picks, slots and kept pairs,
schemas and parameter counts.  Float results (the MoE aux loss among
them) are held to

    max |port - jax| / max |jax|  <  RTOL = 1e-4

(float32; the two frameworks sum in other orders, which moves the last
few bits of a float32, about 1e-6 of the largest value at these sizes).
The SSM, RG-LRU and encoder-decoder archs are held by
``tests/test_torch_recurrent.py``.
``moe_ffn`` and ``mla_attention`` also run on bfloat16 leaves and
activations, cast at the reference's points, held to ``BF16_RTOL`` = 2^-6,
four bf16 steps of the largest value.  Each architecture's JAX side
runs once, in a thread of its own started with the first test that needs
one, and is shared by its tests.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import schema as jschema
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import schema as tschema

RTOL = 1e-4
BF16_RTOL = 2**-6
GQA_ARCHS = ["qwen3-8b", "deepseek-7b", "gemma-7b", "starcoder2-15b", "qwen2-vl-7b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b"]
SERVED_ARCHS = GQA_ARCHS + MOE_ARCHS
B, S, STEPS = 2, 24, 4


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def cpu(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def jax_tree(tree):
    """A JAX pytree of nested dicts as numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.cache
def _jax_jobs():
    """Every arch's JAX side, started at once, a thread each (the JAX package
    compiles while it runs, outside the interpreter lock)."""
    pool = ThreadPoolExecutor(len(SERVED_ARCHS))
    return {name: pool.submit(_jax_side, name) for name in SERVED_ARCHS}


def jax_side(name):
    return _jax_jobs()[name].result()


def _jax_side(name):
    """The JAX package's forward, prefill and greedy decode on one arch."""
    cfg = jconfigs.make_smoke(jconfigs.get_config(name))
    params = jmodel.init(cfg, 0)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, _, aux = jmodel.forward(params, cfg, batch, remat=False)
    last, cache = jmodel.prefill(params, cfg, batch, remat=False)
    out = {
        "params": jax_tree(params),
        "tokens": tokens,
        "logits": np.asarray(logits),
        "aux": np.asarray(aux),
        "last": np.asarray(last),
        "cache": jax_tree(cache),
    }
    tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    steps = []
    for _ in range(STEPS):
        lg, cache = jmodel.decode_step(params, cfg, cache, tok)
        tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        steps.append((np.asarray(lg), np.asarray(tok)))
    out["steps"] = steps
    out["decoded"] = jax_tree(cache)
    return out


def port_side(name):
    cfg = tconfigs.make_smoke(tconfigs.get_config(name))
    ref = jax_side(name)
    params = tmodel.from_numpy(cfg, ref["params"], device="cpu")
    return cfg, params, ref, {"tokens": torch.from_numpy(ref["tokens"])}


def check_cache(got, want):
    """k/v within tolerance, kpos and pos exact, leaf for leaf."""
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], dict):
            check_cache(got[key], want[key])
        elif key in ("kpos", "pos"):
            np.testing.assert_array_equal(cpu(got[key]), want[key])
            assert got[key].dtype == torch.int32
        else:
            assert rel_err(cpu(got[key]), want[key]) < RTOL, key


@pytest.mark.parametrize("name", SERVED_ARCHS)
def test_forward_matches_jax(name):
    """Logits, and the MoE aux loss summed over the layers (0 without MoE)."""
    cfg, params, ref, batch = port_side(name)
    logits, _, aux = tmodel.forward(params, cfg, batch)
    assert rel_err(cpu(logits), ref["logits"]) < RTOL
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(cpu(aux), ref["aux"], rtol=RTOL, atol=0)
    assert (float(ref["aux"]) > 0) == cfg.is_moe


@pytest.mark.parametrize("name", SERVED_ARCHS)
def test_prefill_matches_jax(name):
    cfg, params, ref, batch = port_side(name)
    last, cache = tmodel.prefill(params, cfg, batch)
    assert rel_err(cpu(last), ref["last"]) < RTOL
    check_cache(cache, ref["cache"])


@pytest.mark.parametrize("name", SERVED_ARCHS)
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


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("path", ["naive", "chunked"])
def test_attend_matches_jax(path, softcap, window):
    """Both of ``attend``'s paths; the chunked one on a ragged KV length
    (padded with kpos = -1 slots) and a query chunk of 8."""
    rng = np.random.default_rng(11)
    Bq, Sq, Sk, KV, G, Dh = 2, 16, 20, 2, 3, 8
    q = rng.normal(size=(Bq, Sq, KV, G, Dh)).astype(np.float32) * 3
    k = rng.normal(size=(Bq, Sk, KV, Dh)).astype(np.float32) * 3
    v = rng.normal(size=(Bq, Sk, KV, Dh)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(Sk - Sq, Sk, dtype=np.int32), (Bq, Sq))
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (Bq, Sk)).copy()
    k_pos[1, :3] = -1  # empty slots
    kw = dict(causal=True, window=window, softcap=softcap)
    if path == "chunked":
        kw.update(chunk_threshold=8, q_chunk=8, kv_chunk=8)
    want = jattention.attend(*map(jnp.asarray, (q, k, v, q_pos, k_pos)), **kw)
    got = tattention.attend(*map(torch.from_numpy, (q, k, v, q_pos.copy(), k_pos)), **kw)
    assert rel_err(cpu(got), np.asarray(want)) < RTOL


@pytest.mark.parametrize(
    "fn", ["rms_norm", "rms_norm_offset", "layer_norm", "rope", "mrope",
           "swiglu", "geglu", "gelu", "embed_scaled"],
)
def test_layers_match_jax(fn):
    """The layer functions, float32 and bfloat16 (cast back at the reference's
    points: bf16 results equal to the last bit or within one bf16 step)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32) * 7, (2, 6)).copy()
    p = {k: rng.normal(size=s).astype(np.float32) * 0.3
         for k, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    table = rng.normal(size=(50, 16)).astype(np.float32)
    tokens = rng.integers(0, 50, (2, 6)).astype(np.int32)
    calls = {
        "rms_norm": lambda m, a: m.rms_norm(a(x), a(w), 1e-6),
        "rms_norm_offset": lambda m, a: m.rms_norm(a(x), a(w), 1e-6, offset=1.0),
        "layer_norm": lambda m, a: m.layer_norm(a(x), a(w), a(w[::-1].copy()), 1e-5),
        "rope": lambda m, a: m.apply_rope(a(x), a(pos), 10_000.0),
        "mrope": lambda m, a: m.apply_mrope(a(x), a(np.stack([pos, pos + 1, pos * 2])), (2, 3, 3)),
        "swiglu": lambda m, a: m.mlp({k: a(v) for k, v in p.items()}, a(x[..., 0, :]), "swiglu"),
        "geglu": lambda m, a: m.mlp({k: a(v) for k, v in p.items()}, a(x[..., 0, :]), "geglu"),
        "gelu": lambda m, a: m.mlp({k: a(v) for k, v in p.items()}, a(x[..., 0, :]), "gelu"),
        "embed_scaled": lambda m, a: m.embed_tokens(a(table), a(tokens), True, 3072),
    }
    for dtype in ("float32", "bfloat16"):
        def to_jax(a, dtype=dtype):
            return jnp.asarray(a).astype(dtype) if a.dtype == np.float32 else jnp.asarray(a)

        def to_torch(a, dtype=dtype):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(getattr(torch, dtype)) if t.dtype == torch.float32 else t

        want = calls[fn](jl, to_jax)
        got = calls[fn](tl, to_torch)
        assert str(got.dtype) == f"torch.{want.dtype}"
        want = np.asarray(want.astype(jnp.float32))
        got = cpu(got.float())
        if dtype == "float32":
            assert rel_err(got, want) < RTOL
        elif fn not in ("swiglu", "geglu", "gelu"):  # bf16 products: summed in another order
            np.testing.assert_allclose(got, want, rtol=2**-7, atol=0)


@pytest.mark.parametrize("kind", ["self", "cross", "no_rope"])
def test_gqa_attention_matches_jax(kind):
    """The GQA layer with qk-norm and RoPE, as cross-attention over an encoder
    output, and without RoPE."""
    cfg = jconfigs.make_smoke(jconfigs.get_config("qwen3-8b"))
    tcfg = tconfigs.make_smoke(tconfigs.get_config("qwen3-8b"))
    rng = np.random.default_rng(14)
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": rng.normal(size=(d, H, Dh)) * d**-0.5,
        "wk": rng.normal(size=(d, KV, Dh)) * d**-0.5,
        "wv": rng.normal(size=(d, KV, Dh)) * d**-0.5,
        "wo": rng.normal(size=(H, Dh, d)) * 0.02,
        "q_norm": 1 + 0.1 * rng.normal(size=(Dh,)),
        "k_norm": 1 + 0.1 * rng.normal(size=(Dh,)),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 10, d)).astype(np.float32)
    enc = rng.normal(size=(2, 7, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    kw = {"self": {}, "cross": {"is_cross": True, "causal": False},
          "no_rope": {"use_rope": False}}[kind]

    def run(attention, a):
        kv_from = a(enc) if kind == "cross" else None
        return attention.gqa_attention({k: a(v) for k, v in p.items()}, a(x), cfg_of[attention],
                                       a(pos), kv_from=kv_from, **kw)

    cfg_of = {jattention: cfg, tattention: tcfg}
    want, _, (wk, wv) = run(jattention, jnp.asarray)
    got, (gk, gv) = run(tattention, torch.from_numpy)
    assert rel_err(cpu(got), np.asarray(want)) < RTOL
    assert rel_err(cpu(gk), np.asarray(wk)) < RTOL
    assert rel_err(cpu(gv), np.asarray(wv)) < RTOL


@pytest.mark.parametrize("length", [40, 10])  # length >= S, and a wrapped ring
def test_ring_gather_matches_jax(length):
    rng = np.random.default_rng(12)
    S_ = 24
    kv = rng.normal(size=(2, S_, 3, 4)).astype(np.float32)
    want, want_idx = jmodel._ring_gather(jnp.asarray(kv), S_, length)
    got, got_idx = tmodel._ring_gather(torch.from_numpy(kv), S_, length)
    np.testing.assert_array_equal(cpu(got), np.asarray(want))
    np.testing.assert_array_equal(cpu(got_idx), np.asarray(want_idx))
    assert got_idx.dtype == torch.int32
    # the stacked layout: the sequence on axis 2, behind a layer axis
    stacked, idx = tmodel._ring_gather(torch.from_numpy(np.stack([kv, -kv])), S_, length, axis=2)
    np.testing.assert_array_equal(cpu(stacked), np.stack([np.asarray(want), -np.asarray(want)]))
    np.testing.assert_array_equal(cpu(idx), np.asarray(want_idx))


def schema_leaves(schema, is_leaf):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(schema, is_leaf=is_leaf)
    return [(tuple(p.key for p in path), tuple(leaf)) for path, leaf in flat]


@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_full_schema_matches_jax(name):
    """Every leaf at full width: path, shape, logical axes, init, scale and
    dtype, without allocating; the ``meta`` params have its shapes and dtypes."""
    assert tconfigs.ARCHS == jconfigs.ARCHS
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    assert tcfg == tconfigs.ModelConfig(**jcfg.__dict__)
    want = schema_leaves(jmodel.schema(jcfg), jschema.is_param)
    tsch = tmodel.schema(tcfg)
    got = [(path, tuple(leaf)) for path, leaf in tschema.tree_items(tsch)]
    assert got == want
    abstract = dict(tschema.tree_items(tmodel.abstract(tcfg)))
    for path, p in tschema.tree_items(tsch):
        t = abstract[path]
        assert t.device.type == "meta"
        assert tuple(t.shape) == p.shape
        assert str(t.dtype) == f"torch.{p.dtype or tcfg.param_dtype}"


def schema_total(cfg) -> int:
    return sum(int(np.prod(p.shape)) for _, p in tschema.tree_items(tmodel.schema(cfg)))


def test_param_count_vs_schema():
    """Analytic param count must be within 1.5% of the real tree (big cfgs)."""
    for name in tconfigs.ARCHS:
        cfg = tconfigs.get_config(name)
        total, analytic = schema_total(cfg), cfg.param_count()
        jax_leaves = schema_leaves(jmodel.schema(jconfigs.get_config(name)), jschema.is_param)
        assert total == sum(int(np.prod(leaf[0])) for _, leaf in jax_leaves)
        rel = abs(total - analytic) / total
        assert rel < 0.015, f"{name}: schema {total:,} vs analytic {analytic:,}"


def test_full_config_headline_params():
    """Sanity: full configs land near their nameplate sizes."""
    expect = {
        "grok-1-314b": (290e9, 340e9),
        "deepseek-v2-lite-16b": (14e9, 18e9),
        "qwen3-8b": (7e9, 9.5e9),
        "gemma-7b": (7.5e9, 9.5e9),
        "deepseek-7b": (6e9, 8e9),
        "starcoder2-15b": (14e9, 17e9),
        "mamba2-130m": (0.1e9, 0.2e9),
        "recurrentgemma-9b": (8e9, 11e9),
        "qwen2-vl-7b": (6.5e9, 8.5e9),
        "whisper-large-v3": (1.2e9, 2.2e9),
    }
    for name, (lo, hi) in expect.items():
        total = schema_total(tconfigs.get_config(name))
        assert lo <= total <= hi, f"{name}: {total/1e9:.2f}B not in [{lo/1e9}, {hi/1e9}]"
    assert schema_total(tconfigs.get_config("qwen3-8b")) == 8_190_735_360


@pytest.mark.parametrize("name", ["qwen3-8b", "gemma-7b", "mamba2-130m"])
def test_init_fixed_leaves_equal_the_schema(name):
    """``init``'s zeros/ones/const leaves hold the schema's values (the JAX
    package's, by the schema test); random leaves have its shapes and dtypes."""
    cfg = tconfigs.make_smoke(tconfigs.get_config(name))
    params = dict(tschema.tree_items(tmodel.init(cfg, 3, device="cpu")))
    again = dict(tschema.tree_items(tmodel.init(cfg, 3, device="cpu")))
    for path, p in tschema.tree_items(tmodel.schema(cfg)):
        t = params[path]
        assert tuple(t.shape) == p.shape and t.dtype == getattr(torch, p.dtype or cfg.param_dtype)
        fixed = {"zeros": 0.0, "ones": 1.0, "const": p.scale}.get(p.init)
        if fixed is not None:
            assert bool((t == fixed).all()), path
        assert torch.equal(t, again[path])  # one seed, one draw


def test_numpy_round_trip_keeps_bf16_bits():
    """The JAX package's bfloat16 params go across by their bits and come back."""
    jcfg = jconfigs.make_smoke(jconfigs.get_config("qwen3-8b")).replace(
        param_dtype="bfloat16", act_dtype="bfloat16"
    )
    tcfg = tconfigs.make_smoke(tconfigs.get_config("qwen3-8b")).replace(
        param_dtype="bfloat16", act_dtype="bfloat16"
    )
    tree = jax_tree(jmodel.init(jcfg, 0))
    params = tmodel.from_numpy(tcfg, tree, device="cpu")
    assert params["tok_embed"].dtype == torch.bfloat16
    back = tmodel.to_numpy(params)
    want = dict(tschema.tree_items(tree))
    for path, a in tschema.tree_items(back):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, want[path].view(np.uint16))
    again = tmodel.to_numpy(tmodel.from_numpy(tcfg, back, device="cpu"))
    for (path, a), (_, b) in zip(tschema.tree_items(back), tschema.tree_items(again)):
        np.testing.assert_array_equal(a, b)
    # the same bits as float32 values, cast the way JAX casts
    embed = jnp.asarray(tree["tok_embed"]).astype(jnp.float32)
    np.testing.assert_array_equal(cpu(params["tok_embed"].float()), np.asarray(embed))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_from_numpy_rejects_a_wrong_tree(fault):
    cfg = tconfigs.make_smoke(tconfigs.get_config("deepseek-7b"))
    tree = tmodel.to_numpy(tmodel.init(cfg, 0, device="cpu"))
    if fault == "missing":
        del tree["layers"]["b0"]["mlp"]["wg"]
    elif fault == "extra":
        tree["layers"]["b0"]["attn"]["q_norm"] = np.ones(32, np.float32)
    elif fault == "shape":
        tree["lm_head"] = tree["lm_head"].T
    else:
        tree["final_norm"]["scale"] = tree["final_norm"]["scale"].astype(np.float64)
    with pytest.raises(ValueError):
        tmodel.from_numpy(cfg, tree, device="cpu")


def test_init_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.make_smoke(tconfigs.get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init(cfg, 0)


# ---------------------------------------------------------------------------
# The MoE + MLA slice's parts
# ---------------------------------------------------------------------------


def moe_params(cfg, rng):
    """Random MoE leaves of the schema's shapes; the router at 1/sqrt(d), so
    the picks are uneven enough that the capacity drops pairs."""
    sch = tmodel._moe_schema(cfg)
    p = {k: rng.normal(size=v.shape) * v.shape[-2] ** -0.5 for k, v in sch.items()}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_ffn_matches_jax(name, dtype):
    """``moe_ffn`` at the config's capacity factor, with drops: the router's
    picks, each pair's slot (where kept), ``keep`` and token exact; the
    output and the aux loss within ``RTOL`` (``BF16_RTOL`` in bf16).  A pick
    flipped at a gap between the k-th and (k+1)-th probability above the
    dtype's noise is a fault; the smallest gap at this seed is reported."""
    jcfg = jconfigs.make_smoke(jconfigs.get_config(name))
    tcfg = tconfigs.make_smoke(tconfigs.get_config(name))
    rng = np.random.default_rng(15)
    p = moe_params(tcfg, rng)
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    E, k = tcfg.n_experts, tcfg.top_k
    capacity = tmoe.expert_capacity(tcfg, S)
    assert capacity == 8  # int(24 * 2 / 8 * 1.25) = 7, rounded up to a multiple of 8
    tol = RTOL if dtype == "float32" else BF16_RTOL

    jp = {key: jnp.asarray(v).astype(dtype) for key, v in p.items()}
    tp = {key: torch.from_numpy(v).to(getattr(torch, dtype)) for key, v in p.items()}
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    want_y, want_aux = jmoe.moe_ffn(jp, jx, jcfg)
    got_y, got_aux = tmoe.moe_ffn(tp, tx, tcfg)
    assert str(got_y.dtype) == f"torch.{want_y.dtype}"
    assert rel_err(cpu(got_y.float()), np.asarray(want_y.astype(jnp.float32))) < tol
    np.testing.assert_allclose(cpu(got_aux), np.asarray(want_aux), rtol=tol, atol=0)

    # the routing, as the reference's moe_ffn computes it (moe.py:75-78)
    logits = jnp.einsum("bsd,de->bse", jx, jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    want_w, want_idx = jax.lax.top_k(probs, k)
    want_w = want_w / jnp.maximum(want_w.sum(-1, keepdims=True), 1e-9)
    got_probs, got_w, got_idx = tmoe.route(tp, tx, tcfg)
    ranked = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    gap = float(np.min(ranked[..., k - 1] - ranked[..., k]))
    print(f"{name} ({dtype}): smallest gap between a token's probabilities {k} and {k + 1}: "
          f"{gap:.3e}")
    np.testing.assert_array_equal(cpu(got_idx), np.asarray(want_idx), err_msg=f"gap {gap}")
    assert rel_err(cpu(got_probs), np.asarray(probs)) < tol
    assert rel_err(cpu(got_w), np.asarray(want_w)) < tol

    want = jax.vmap(lambda xr, ti, tw: jmoe._dispatch_row(xr, ti, tw, E, capacity)[1])(
        jx, want_idx.astype(jnp.int32), want_w
    )
    _, (slot, st, _, keep) = tmoe._dispatch(tx, got_idx, got_w, E, capacity)
    w_slot, w_st, _, w_keep = map(np.asarray, want)
    np.testing.assert_array_equal(cpu(keep), w_keep)
    assert not w_keep.all()  # the capacity drops pairs at this seed
    np.testing.assert_array_equal(cpu(st), w_st)
    np.testing.assert_array_equal(cpu(slot)[w_keep], w_slot[w_keep])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_route_breaks_ties_to_the_lower_expert(name):
    """Tied router probabilities (bf16 logits tie often) pick as
    ``lax.top_k`` does: the larger first, the lower expert first on a tie."""
    cfg = tconfigs.make_smoke(tconfigs.get_config(name))
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    router = np.zeros((d, E), np.float32)
    router[0, ::3] = 1.0  # experts 0, 3, 6, ... tie high on the first feature
    router[1, 1::2] = 0.5  # the odd experts tie lower on the second
    x = np.zeros((B, S, d), np.float32)
    x[0, :, 0] = 1.0
    x[1, :, 1] = 1.0
    x[1, :4] = 0.0  # all E tie
    want_w, want_idx = jax.lax.top_k(
        jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), jnp.asarray(router)), -1), k
    )
    _, got_w, got_idx = tmoe.route({"router": torch.from_numpy(router)}, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(cpu(got_idx), np.asarray(want_idx))
    np.testing.assert_array_equal(cpu(got_idx)[1, :4], np.broadcast_to(np.arange(k), (4, k)))
    want_w = want_w / jnp.maximum(want_w.sum(-1, keepdims=True), 1e-9)
    assert rel_err(cpu(got_w), np.asarray(want_w)) < RTOL


@pytest.mark.parametrize("capacity", [4, S * 2])  # drops, and none
def test_dispatch_and_combine_match_the_jax_vmap(capacity):
    """The batched dispatch and combine against the reference's per-row
    functions under ``jax.vmap``: the capacity buffer and the metadata
    exact (a dropped pair's slot is the dump row ``E C`` here, 2^31 - 1
    there), the combined rows within ``RTOL``."""
    rng = np.random.default_rng(16)
    E, k, d = 8, 2, 16
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    top_idx = np.argsort(rng.random((B, S, E)) ** 3, axis=-1)[..., :k].astype(np.int32)
    top_w = rng.random((B, S, k)).astype(np.float32)
    ye = rng.normal(size=(B, E, capacity, d)).astype(np.float32)

    want_xe, want_meta = jax.vmap(lambda xr, ti, tw: jmoe._dispatch_row(xr, ti, tw, E, capacity))(
        *map(jnp.asarray, (x, top_idx, top_w))
    )
    want_y = jax.vmap(lambda yr, mt: jmoe._combine_row(yr, mt, S))(jnp.asarray(ye), want_meta)
    got_xe, got_meta = tmoe._dispatch(
        torch.from_numpy(x), torch.from_numpy(top_idx).long(), torch.from_numpy(top_w), E, capacity
    )
    got_y = tmoe._combine(torch.from_numpy(ye), got_meta, S)

    np.testing.assert_array_equal(cpu(got_xe), np.asarray(want_xe))
    slot, st, sw, keep = map(cpu, got_meta)
    w_slot, w_st, w_sw, w_keep = map(np.asarray, want_meta)
    np.testing.assert_array_equal(keep, w_keep)
    np.testing.assert_array_equal(st, w_st)
    np.testing.assert_array_equal(sw, w_sw)
    np.testing.assert_array_equal(slot, np.where(w_keep, w_slot, E * capacity))
    assert keep.all() == (capacity == S * 2)
    assert rel_err(cpu(got_y), np.asarray(want_y)) < RTOL


def scatter_add_combine(ye, meta, S: int):
    """The combine as it stood before it summed in a fixed order: each
    pair's weighted output added onto its token by ``scatter_add_`` (on the
    card by atomics, in no fixed order)."""
    slot, st, sw, keep = meta
    B_, E, C, d = ye.shape
    yf = ye.reshape(B_, E * C, d)
    idx = torch.clamp(slot, max=E * C - 1)[..., None].expand(-1, -1, d)
    contrib = yf.gather(1, idx) * sw[..., None].to(yf.dtype)
    contrib = torch.where(keep[..., None], contrib, 0)
    return ye.new_zeros((B_, S, d)).scatter_add_(1, st[..., None].expand(-1, -1, d), contrib), contrib


def combine_inputs(dtype, seed=17, E=16, k=6, capacity=4):
    """Seeded routing of DeepSeek-V2-Lite's top-k (6) over 16 experts, at a
    capacity that drops pairs, and expert outputs in ``dtype``."""
    rng = np.random.default_rng(seed)
    d = 32
    x = torch.from_numpy(rng.normal(size=(B, S, d)).astype(np.float32)).to(getattr(torch, dtype))
    top_idx = torch.from_numpy(np.argsort(rng.random((B, S, E)) ** 3, axis=-1)[..., :k].copy())
    top_w = torch.from_numpy(rng.random((B, S, k)).astype(np.float32))
    _, meta = tmoe._dispatch(x, top_idx, top_w, E, capacity)
    ye = torch.from_numpy(rng.normal(size=(B, E, capacity, d)).astype(np.float32))
    return x, top_idx, top_w, meta, ye.to(getattr(torch, dtype))


def bits(t) -> np.ndarray:
    return cpu(t.view(torch.int16) if t.dtype == torch.bfloat16 else t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_sums_each_token_in_expert_order(dtype):
    """``_combine`` adds each token's k contributions one pick at a time in
    ascending expert order, in ``ye``'s dtype, a dropped pair adding 0: bit
    for bit the reference's ``.at[st].add`` (``_combine_row`` under
    ``jax.vmap``) in float32 and bfloat16, and in float32 bit for bit the
    old ``scatter_add_`` formula.  In bfloat16 this CPU's ``scatter_add_``
    sums a token's contributions in float32 and rounds once, where the
    reference rounds after each add; there the old formula sits within
    the k roundings of the sum (unit roundoff 2^-8 of its absolute sum)."""
    x, top_idx, top_w, meta, ye = combine_inputs(dtype)
    E, C = ye.shape[1:3]
    k = top_idx.shape[-1]
    assert not meta[3].all()  # pairs dropped
    got = tmoe._combine(ye, meta, S)
    old, contrib = scatter_add_combine(ye, meta, S)
    jdt = getattr(jnp, dtype)
    _, jmeta = jax.vmap(lambda xr, ti, tw: jmoe._dispatch_row(xr, ti, tw, E, C))(
        jnp.asarray(x.float().numpy()).astype(jdt), jnp.asarray(top_idx.numpy().astype(np.int32)),
        jnp.asarray(top_w.numpy()))
    want = jax.vmap(lambda yr, mt: jmoe._combine_row(yr, mt, S))(
        jnp.asarray(ye.float().numpy()).astype(jdt), jmeta)
    assert got.dtype == ye.dtype
    np.testing.assert_array_equal(cpu(got.float()), np.asarray(want.astype(jnp.float32)))
    if dtype == "float32":
        np.testing.assert_array_equal(bits(got), bits(old))
    else:
        abs_sum = ye.new_zeros(got.shape, dtype=torch.float32).scatter_add_(
            1, meta[1][..., None].expand(-1, -1, got.shape[-1]), contrib.float().abs())
        gap = (got.float() - old.float()).abs()
        assert bool((gap <= k * 2.0**-8 * abs_sum).all())


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten operations dispatched while the mode is on, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _adds_by_index(names) -> list:
    return [n for n in names if "scatter_add" in n or "index_add" in n or "scatter_reduce" in n]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_forward_issues_no_scatter_add(dtype):
    """``moe_ffn``'s forward issues no ``scatter_add`` or ``index_add`` (each
    sums by atomics on the card, in no fixed order), and the gradient of
    the dispatch's row gather, which sums each token's k gradient rows,
    none either.  The recorder sees them where they are: in the old
    combine and in a plain ``gather``'s backward."""
    name = "deepseek-v2-lite-16b"
    cfg = tconfigs.make_smoke(tconfigs.get_config(name))
    rng = np.random.default_rng(15)
    tdt = getattr(torch, dtype)
    p = {key: torch.from_numpy(v).to(tdt) for key, v in moe_params(cfg, rng).items()}
    x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)).to(tdt)
    with _Ops() as ops:
        tmoe.moe_ffn(p, x, cfg)
    assert any("gather" in n for n in ops.names) and not _adds_by_index(ops.names)

    xg, top_idx, top_w, meta, ye = combine_inputs(dtype)
    with _Ops() as ops:
        scatter_add_combine(ye, meta, S)
    assert _adds_by_index(ops.names)  # the recorder sees the old combine's

    xg = xg.detach().requires_grad_(True)
    E, C, d = ye.shape[1], ye.shape[2], xg.shape[-1]
    xe, _ = tmoe._dispatch(xg, top_idx, top_w, E, C)
    g = torch.from_numpy(np.random.default_rng(18).normal(size=xe.shape).astype(np.float32))
    with _Ops() as ops:
        got, = torch.autograd.grad(xe, xg, g.to(xe.dtype))
    assert not _adds_by_index(ops.names)
    # the same dispatch with a plain gather: its backward adds by index
    slot, st = meta[0], meta[1]
    with _Ops() as ops:
        plain = xg.new_zeros((B, E * C + 1, d)).scatter_(
            1, slot[..., None].expand(-1, -1, d), tmoe._take(xg, st))[:, : E * C]
        want, = torch.autograd.grad(plain.reshape(xe.shape), xg, g.to(xe.dtype))
    assert _adds_by_index(ops.names)
    if dtype == "float32":
        np.testing.assert_array_equal(bits(got), bits(want))
    else:  # each token's k rows rounded once there, after each add here
        x32 = xg.detach().float().requires_grad_(True)
        plain32 = x32.new_zeros((B, E * C + 1, d)).scatter_(
            1, slot[..., None].expand(-1, -1, d), tmoe._take(x32, st))[:, : E * C]
        abs_sum, = torch.autograd.grad(plain32.reshape(xe.shape), x32, g.abs())
        k = top_idx.shape[-1]
        assert bool(((got.float() - want.float()).abs() <= k * 2.0**-8 * abs_sum).all())


def mla_params(cfg, rng):
    sch = tmodel._mla_schema(cfg)
    p = {key: rng.normal(size=v.shape) * v.shape[0] ** -0.5 for key, v in sch.items()}
    p["kv_norm"] = 1 + 0.1 * rng.normal(size=sch["kv_norm"].shape)
    return {key: v.astype(np.float32) for key, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["naive", "chunked", "decode"])
def test_mla_attention_matches_jax(path, dtype, monkeypatch):
    """MLA's absorbed prefill on ``attend``'s naive and chunked paths (the
    chunked one with 8-position chunks over a ragged 24, values of the
    latent width 32 beside queries of 48), and the split decode over a
    cache with empty and future slots; float32 within ``RTOL``, bf16
    within ``BF16_RTOL``."""
    jcfg = jconfigs.make_smoke(jconfigs.get_config("deepseek-v2-lite-16b"))
    tcfg = tconfigs.make_smoke(tconfigs.get_config("deepseek-v2-lite-16b"))
    rng = np.random.default_rng(17)
    p = mla_params(tcfg, rng)
    Sq = 1 if path == "decode" else S
    x = rng.normal(size=(B, Sq, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    cache = None
    if path == "decode":
        T = 20
        pos[:] = 13
        cache = {
            "c_kv": rng.normal(size=(B, T, tcfg.kv_lora_rank)).astype(np.float32),
            "k_rope": rng.normal(size=(B, T, tcfg.qk_rope_dim)).astype(np.float32),
            "kpos": np.where(np.arange(T) < 16, np.arange(T), -1).astype(np.int32)[None].repeat(B, 0),
        }
        cache["kpos"][1, 3] = -1
    if path == "chunked":
        for job in _jax_jobs().values():
            job.result()  # no JAX model of the pool runs while attend is patched
        kw = dict(chunk_threshold=8, q_chunk=8, kv_chunk=16)
        monkeypatch.setattr(jattention, "attend", functools.partial(jattention.attend, **kw))
        monkeypatch.setattr(tattention, "attend", functools.partial(tattention.attend, **kw))

    def run(attention, cfg, a):
        c = None if cache is None else {key: a(v) for key, v in cache.items()}
        return attention.mla_attention({key: a(v) for key, v in p.items()}, a(x), cfg, a(pos), cache=c)

    def to_jax(a):
        return jnp.asarray(a).astype(dtype) if a.dtype == np.float32 else jnp.asarray(a)

    def to_torch(a):
        t = torch.from_numpy(a)
        return t.to(getattr(torch, dtype)) if t.dtype == torch.float32 else t

    tol = RTOL if dtype == "float32" else BF16_RTOL
    want = run(jattention, jcfg, to_jax)
    got_out, got_kv = run(tattention, tcfg, to_torch)
    want_out, want_kv = want[0], want[2]
    if path == "decode":
        assert sorted(got_kv) == ["c_kv", "k_rope"]
        got_kv, want_kv = (got_kv["c_kv"], got_kv["k_rope"]), (want_kv["c_kv"], want_kv["k_rope"])
    for g, w in zip((got_out, *got_kv), (want_out, *want_kv)):
        assert str(g.dtype) == f"torch.{w.dtype}"
        assert rel_err(cpu(g.float()), np.asarray(w.astype(jnp.float32))) < tol


@pytest.mark.parametrize("name", SERVED_ARCHS)
def test_init_cache_matches_jax(name):
    """The empty cache leaf for leaf: paths, shapes, dtypes and values
    (the MLA latents ``c_kv``/``k_rope`` and the ``prefix_0`` group too)."""
    jcfg = jconfigs.make_smoke(jconfigs.get_config(name))
    tcfg = tconfigs.make_smoke(tconfigs.get_config(name))
    want = dict(tschema.tree_items(jax_tree(jmodel.init_cache(jcfg, B, 40))))
    got = dict(tschema.tree_items(tmodel.init_cache(tcfg, B, 40, device="cpu")))
    assert sorted(got) == sorted(want)
    if name == "deepseek-v2-lite-16b":
        assert ("prefix_0", "attn", "c_kv") in got and ("layers", "b0", "attn", "k_rope") in got
    for path, w in want.items():
        assert str(got[path].dtype) == f"torch.{w.dtype}", path
        np.testing.assert_array_equal(cpu(got[path]), w)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_matches_full_forward(name):
    """Prefill S and decode the next token against ``forward`` over S + 1,
    at a capacity factor that drops no pair (as ``tests/test_archs.py``)."""
    cfg = tconfigs.make_smoke(tconfigs.get_config(name)).replace(capacity_factor=64.0)
    params = tmodel.init(cfg, 0, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    )
    full, _, _ = tmodel.forward(params, cfg, {"tokens": toks})
    last, cache = tmodel.prefill(params, cfg, {"tokens": toks[:, :S]})
    step, cache = tmodel.decode_step(params, cfg, cache, toks[:, S:])
    assert rel_err(cpu(last), cpu(full[:, S - 1])) < RTOL
    assert rel_err(cpu(step), cpu(full[:, S])) < RTOL
    assert int(cache["pos"]) == S + 1


def test_numpy_round_trip_carries_moe_and_prefix_leaves():
    """DeepSeek-V2-Lite's tree (its leading dense layer ``prefix_0``, the
    stacked ``moe`` and MLA leaves) goes across by its bits and comes back."""
    cfg = dict(param_dtype="bfloat16", act_dtype="bfloat16")
    jcfg = jconfigs.make_smoke(jconfigs.get_config("deepseek-v2-lite-16b")).replace(**cfg)
    tcfg = tconfigs.make_smoke(tconfigs.get_config("deepseek-v2-lite-16b")).replace(**cfg)
    tree = jax_tree(jmodel.init(jcfg, 0))
    want = dict(tschema.tree_items(tree))
    for path in [("prefix_0", "mlp", "wg"), ("prefix_0", "attn", "w_uk"),
                 ("layers", "b0", "moe", "router"), ("layers", "b0", "moe", "shared_wg"),
                 ("layers", "b0", "attn", "kv_norm")]:
        assert path in want
    back = dict(tschema.tree_items(tmodel.to_numpy(tmodel.from_numpy(tcfg, tree, device="cpu"))))
    assert sorted(back) == sorted(want)
    for path, a in back.items():
        np.testing.assert_array_equal(a, want[path].view(np.uint16), err_msg="/".join(path))
