"""The port's serving path (``repro_torch.serve.serve_step``,
``repro_torch.launch.serve``) against the JAX package on the CPU.

The serve function runs deepseek-7b, the MoE + MLA model
deepseek-v2-lite-16b, and the SSM, RG-LRU and encoder-decoder models
mamba2-130m, recurrentgemma-9b and whisper-large-v3 (whisper with the
frames drawn after the prompts, as the reference draws them), under
``make_smoke`` (the serve test of ``tests/test_system.py``: 4 requests
of 16 tokens, 3 generated) on the JAX package's weights carried across
by ``model.from_numpy``, and must give
the prefix-cache hits, the cache's state and the greedy tokens of the JAX
package's ``prefill``, ``decode_step``, ``sample_greedy`` and
``PrefixCacheFilter`` composed as ``repro/launch/serve.py`` composes them.
All of these are integers and held exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import serve_step as jserve_step
from repro.serve.prefix_cache import PrefixCacheFilter as JaxPrefixCache
from repro_torch import configs as tconfigs
from repro_torch import filters as tf
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serve import serve_step

ARCH, REQUESTS, PROMPT_LEN, GEN, SEED = "deepseek-7b", 4, 16, 3, 0


@functools.cache
def jax_served(arch):
    """``repro/launch/serve.py``'s body on the JAX package, its prefill and
    decode step jitted as there."""
    cfg = jconfigs.make_smoke(jconfigs.get_config(arch))
    params = jmodel.init(cfg, SEED)
    rng = np.random.default_rng(SEED)
    pcache = JaxPrefixCache(q=16, r=14)
    prompts = rng.integers(0, cfg.vocab_size, (REQUESTS, PROMPT_LEN))
    prompts[REQUESTS // 2 :] = prompts[: REQUESTS - REQUESTS // 2]
    hits = pcache.check_and_insert(prompts)
    batch = {"tokens": jnp.asarray(prompts, jnp.int32)}
    frames = None
    if cfg.is_encoder_decoder:
        frames = rng.normal(size=(REQUESTS, cfg.encoder_seq, cfg.d_model))
        batch["frames"] = jnp.asarray(frames, jnp.dtype(cfg.act_dtype))
    logits, cache = jax.jit(lambda p, b: jmodel.prefill(p, cfg, b, remat=False))(params, batch)
    tok = jserve_step.sample_greedy(logits)[:, None]
    decode = jax.jit(lambda p, c, t: jmodel.decode_step(p, cfg, c, t))
    out = [tok]
    for _ in range(GEN - 1):
        logits, cache = decode(params, cache, tok)
        tok = jserve_step.sample_greedy(logits)[:, None]
        out.append(tok)
    return {
        "params": jax.tree_util.tree_map(np.asarray, params),
        "prompts": prompts,
        "frames": frames,
        "hits": np.asarray(hits),
        "tokens": np.asarray(jnp.concatenate(out, axis=1)),
        "state": [np.array(x) for x in jax.tree_util.tree_leaves(pcache.state)],
    }


def check_served(arch):
    """``serve`` on the JAX package's weights: prompts, hits, tokens and the
    prefix cache's state equal to the JAX serve script's."""
    ref = jax_served(arch)
    cfg = tconfigs.make_smoke(tconfigs.get_config(arch))
    prompts, frames = tserve.make_requests(cfg, REQUESTS, PROMPT_LEN, SEED)
    np.testing.assert_array_equal(prompts, ref["prompts"])
    if cfg.is_encoder_decoder:
        np.testing.assert_array_equal(frames, ref["frames"])
    else:
        assert frames is None and ref["frames"] is None
    params = tmodel.from_numpy(cfg, ref["params"], device="cpu")
    hits, tokens, pcache = tserve.serve(cfg, params, prompts, GEN, "cpu", frames)
    np.testing.assert_array_equal(hits, ref["hits"])
    assert hits[REQUESTS // 2 :].all()
    assert tokens.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])
    got = tf.to_numpy(pcache.cfg, pcache.state)
    assert len(got) == len(ref["state"])
    for a, b in zip(ref["state"], got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_serve_matches_the_jax_serve_script():
    check_served(ARCH)


def test_serve_moe_matches_the_jax_serve_script():
    """The same on deepseek-v2-lite-16b: MLA, a leading dense layer and MoE
    layers at the config's capacity factor."""
    check_served("deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b", "whisper-large-v3"])
def test_serve_recurrent_matches_the_jax_serve_script(arch):
    """The same on the SSM, RG-LRU and encoder-decoder archs."""
    check_served(arch)


def test_serve_and_prefill_steps_match_the_model():
    """``make_prefill_step`` is ``prefill`` with no headroom; ``make_serve_step``
    is ``decode_step``."""
    ref = jax_served(ARCH)
    cfg = tconfigs.make_smoke(tconfigs.get_config(ARCH))
    params = tmodel.from_numpy(cfg, ref["params"], device="cpu")
    batch = {"tokens": torch.as_tensor(ref["prompts"], dtype=torch.int32)}
    logits, cache = serve_step.make_prefill_step(cfg)(params, batch)
    assert cache["layers"]["b0"]["attn"]["k"].shape[2] == PROMPT_LEN
    want_logits, want_cache = tmodel.prefill(params, cfg, batch, headroom=0)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    step = serve_step.make_serve_step(cfg)
    tok = serve_step.sample_greedy(logits)[:, None]
    a, cache = step(params, cache, tok)
    b, want_cache = tmodel.decode_step(params, cfg, want_cache, tok)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(cache["pos"]) == PROMPT_LEN + 1
    # the ring wraps with no headroom: slot 0 now holds position 16
    assert cache["layers"]["b0"]["attn"]["kpos"][:, :, 0].eq(PROMPT_LEN).all()


def test_main_on_the_cpu(capsys):
    rc = tserve.main([
        "--arch", ARCH, "--smoke", "--requests", str(REQUESTS),
        "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN), "--device", "cpu",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"prefix-cache hits: {REQUESTS // 2}/{REQUESTS}" in out
    assert f"generated {REQUESTS}x{GEN} tokens" in out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_main_serves_the_moe_archs_on_the_cpu(arch, capsys):
    rc = tserve.main(["--arch", arch, "--smoke", "--requests", "4", "--prompt-len", "16",
                      "--gen", "2", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "prefix-cache hits: 2/4" in out and "generated 4x2 tokens" in out


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b", "whisper-large-v3"])
def test_main_serves_the_recurrent_archs_on_the_cpu(arch, capsys):
    """``--arch mamba2-130m`` is the reference driver's own example."""
    test_main_serves_the_moe_archs_on_the_cpu(arch, capsys)


def test_main_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", ARCH, "--smoke", "--requests", "2", "--gen", "1"])


def test_sample_temperature_is_reproducible():
    logits = torch.from_numpy(np.random.default_rng(5).normal(size=(64, 512)).astype(np.float32))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return [serve_step.sample_temperature(logits, gen) for _ in range(3)]

    a, b = draw(1), draw(1)
    for x, y in zip(a, b):
        assert x.dtype == torch.int32 and x.shape == (64,)
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(a, draw(2)))
    # a temperature near 0 is greedy
    cold = serve_step.sample_temperature(logits, torch.Generator().manual_seed(0), 1e-4)
    assert torch.equal(cold, serve_step.sample_greedy(logits))
