"""The port's training path (``repro_torch.models.model.loss_fn``,
``repro_torch.train``, ``repro_torch.launch.train``) against the JAX
package on the CPU.

Five archs, one of each family (GQA ``qwen3-8b``, MoE + MLA
``deepseek-v2-lite-16b``, SSM ``mamba2-130m``, RG-LRU
``recurrentgemma-9b``, encoder-decoder ``whisper-large-v3``), run under
``make_smoke`` (float32) with the JAX package's ``model.init(cfg, 0)``
carried across by ``model.from_numpy``; RecurrentGemma's leaves first
go to their true fan-in (at ``init``'s smoke scale its RG-LRU gates
saturate, and sqrt(1 - a^2) has an infinite slope at a = 1), and every
gradient is checked finite before it is compared.  Tolerances, fixed
before the first run:

* loss, ``aux``, the step's loss: max |port - jax| / max |jax| < RTOL = 1e-4;
* each gradient leaf and ``grad_norm``: max |port - jax| / max |jax| over
  the leaf < GRAD_RTOL = 1e-3 (a backward pass sums more terms in other
  orders than the forward);
* ``optim.apply`` on identical gradients and state: float32 rounding
  (params rtol 1e-6, atol 1e-7; float32 moments max |Δ| / max |jax|
  < 1e-5 a leaf, since b1 mu + (1 - b1) g cancels); bfloat16 moments
  within one bf16 step; the int8 compression within one quantum;
* params after one AdamW step from the same state (``step_params_close``):
  a step-1 AdamW update is about lr * sign(g), so an element whose
  gradient is near 0, and whose sign may differ, moves by up to 2 lr;
  every element within 2 lr + PTOL(p), and where the reference's new
  first moment is well above its error (|mu| > 2 GRAD_RTOL max |mu| and
  above (1 - b1) 1e-4) within PTOL(p) = 1e-6 + 1e-5 |p|;
* integers exact: ``step``, ``tokens``, the pipeline's counters; ``lr``
  within 1e-6 of itself (each library's float32 cos, its last bit
  scaled by up to 9 in 0.1 + 0.45 (1 + cos)).

The JAX side of every job runs once, in a thread of its own started with
the first test that needs one; the comparisons come first, the
port-only tests after.
"""

import functools
import os
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import schema as tschema
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

RTOL = 1e-4
GRAD_RTOL = 1e-3
ARCHS = ["qwen3-8b", "deepseek-v2-lite-16b", "mamba2-130m", "recurrentgemma-9b",
         "whisper-large-v3"]
B, S = 2, 24


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def cpu(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def jax_tree(tree):
    """A JAX pytree of dicts and NamedTuples as numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(jax_tree(t) for t in tree))
    return None if tree is None else np.asarray(tree)


def at_true_fan_in(cfg, params):
    """The params with each leaf that ``init`` draws at 1/sqrt(fan_in)
    rescaled to the fan-in of its product (the first axis that is neither
    ``layers`` nor ``experts``), as JAX arrays."""
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


def jax_params(name):
    cfg = jconfigs.make_smoke(jconfigs.get_config(name))
    params = jmodel.init(cfg, 0)
    if name == "recurrentgemma-9b":
        params = at_true_fan_in(tconfigs.make_smoke(tconfigs.get_config(name)), params)
    return cfg, params


def make_batch(cfg, b=B, s=S, seed=1) -> dict:
    """Tokens and targets (b, s), a few targets masked (-1), and frames
    for an encoder-decoder; numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    batch["targets"][0, :3] = -1
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def leaves(tree) -> list:
    return tschema.tree_leaves(tree)


def step_params_close(got, want, mu, lr, well_above=2 * GRAD_RTOL, b1=0.9):
    """One AdamW step's params from the same state: every element within
    2 lr (1% slack) + PTOL.  With ``mu`` (the reference's new first
    moment, for a step from zero moments) also: where |mu| >
    ``well_above`` max |mu| and > (1 - b1) 1e-4, within PTOL = 1e-6 +
    1e-5 |p|."""
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        d, tol = np.abs(g - w), 1e-6 + 1e-5 * np.abs(w)
        assert np.all(d <= 2.02 * lr + tol), float(np.max(d - 2.02 * lr - tol))
        if mu is not None:
            m = np.abs(np.asarray(leaves(mu)[i], np.float32))
            well = m > max(well_above * float(np.max(m)), (1 - b1) * 1e-4)
            assert np.all(d[well] <= tol[well]), float(np.max((d - tol)[well]))


# ---------------------------------------------------------------------------
# The JAX side, a thread a job
# ---------------------------------------------------------------------------


def _jax_grads(name):
    """``jax.value_and_grad(model.loss_fn)`` on one arch's smoke params."""
    cfg, params = jax_params(name)
    batch = make_batch(cfg)
    f = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg, b, remat=False), has_aux=True))
    (total, metrics), grads = f(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"params": jax_tree(params), "batch": batch, "total": np.asarray(total),
            "metrics": jax_tree(metrics), "grads": jax_tree(grads)}


def _jax_steps(name, ocfg, steps, microbatches=1, b=B, s=S):
    """``steps`` jitted ``make_train_step`` steps from ``init_state``,
    a batch a step (without remat, which changes no value and compiles
    faster); the states and metrics, as numpy."""
    cfg = jconfigs.make_smoke(jconfigs.get_config(name))
    state = jts.init_state(cfg, ocfg, 0)
    step = jax.jit(jts.make_train_step(cfg, ocfg, microbatches=microbatches, remat=False))
    out = {"states": [jax_tree(state)], "metrics": [], "batches": []}
    for i in range(steps):
        batch = make_batch(cfg, b, s, seed=10 + i)
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out["states"].append(jax_tree(state))
        out["metrics"].append(jax_tree(metrics))
        out["batches"].append(batch)
    return out


def _driver_counters(module, runs):
    """Each ``main(argv)`` of ``module`` (the JAX or the port driver) run
    in turn, and its pipeline's counters at the end of the run."""
    made, make = [], module.DedupPipeline

    def recorded(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    module.DedupPipeline = recorded
    try:
        rcs = [module.main(argv) for argv in runs]
    finally:
        module.DedupPipeline = make
    return rcs, [(p.state.docs_seen, p.state.docs_kept, p.state.docs_dropped) for p in made]


def driver_runs(ckpt, extra=()):
    base = ["--arch", "mamba2-130m", "--smoke", "--batch", "2", "--seq", "64",
            "--ckpt-dir", ckpt, "--ckpt-every", "4", *extra]
    return [base + ["--steps", "8"], base + ["--steps", "10", "--resume"]]


COMPRESSED = dict(compress_grads=True, lr=1e-3)

JOBS = {
    **{f"grads:{name}": functools.partial(_jax_grads, name) for name in ARCHS},
    "microbatches": functools.partial(
        _jax_steps, "qwen3-8b", joptim.OptConfig(), 1, microbatches=2, b=4),
    # test_distributed.py's compressed case on one device: 3 steps at 8 x 64
    "compressed": functools.partial(
        _jax_steps, "mamba2-130m", joptim.OptConfig(**COMPRESSED), 3, b=8, s=64),
}


def _jax_driver(runs):
    """The JAX driver's runs, for its pipeline's counters, which its step
    does not touch: the step returns the state as it is (no model step to
    compile), and the heartbeat timeout lies past any run (its loop beats
    no heartbeat, so a run that outlasts 30 s halts; ROADMAP Queue 3).
    Both are patched in the driver module's own names."""
    from repro.launch import train as jtrain

    def make_step(cfg, ocfg, microbatches=1):
        zero = jnp.zeros((), jnp.float32)
        return lambda state, batch: (state, {"loss": zero, "lr": zero, "grad_norm": zero})

    real_ts, real_ft = jtrain.ts, jtrain.FTConfig
    jtrain.ts = types.SimpleNamespace(init_state=jts.init_state, make_train_step=make_step)
    jtrain.FTConfig = functools.partial(real_ft, heartbeat_timeout_s=float("inf"))
    try:
        return _driver_counters(jtrain, runs)
    finally:
        jtrain.ts, jtrain.FTConfig = real_ts, real_ft


@functools.cache
def _jax_jobs(driver_dir):
    # the driver, the longest job, first
    jobs = {"driver": functools.partial(
        _jax_driver, driver_runs(os.path.join(driver_dir, "jax"))), **JOBS}
    pool = ThreadPoolExecutor(len(jobs))
    return {job: pool.submit(fn) for job, fn in jobs.items()}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX jobs, started together with the first test that needs one.
    The comparisons come first in the file: the port-only tests after
    them would contend with the jobs' tracing for the interpreter lock."""
    jobs = _jax_jobs(str(tmp_path_factory.mktemp("driver")))
    return lambda job: jobs[job].result()


def port_grads(ref, name, remat=True):
    cfg = tconfigs.make_smoke(tconfigs.get_config(name))
    params = tmodel.from_numpy(cfg, ref["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    flat = [t.requires_grad_(True) for t in leaves(params)]
    total, metrics = tmodel.loss_fn(tschema.tree_unflatten(params, flat), cfg, batch, remat=remat)
    return total, metrics, torch.autograd.grad(total, flat)


# ---------------------------------------------------------------------------
# loss_fn and its gradients against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(jax_side, name):
    ref = jax_side(f"grads:{name}")
    total, metrics, grads = port_grads(ref, name)
    assert rel_err(cpu(total), ref["total"]) < RTOL
    assert rel_err(cpu(metrics["loss"]), ref["metrics"]["loss"]) < RTOL
    if name == "deepseek-v2-lite-16b":
        assert float(ref["metrics"]["aux"]) > 0
        assert rel_err(cpu(metrics["aux"]), ref["metrics"]["aux"]) < RTOL
    else:
        assert float(metrics["aux"]) == 0.0 == float(ref["metrics"]["aux"])
    assert metrics["tokens"].dtype == torch.float32
    assert float(metrics["tokens"]) == float(ref["metrics"]["tokens"]) == B * S - 3
    want = [g for _, g in tschema.tree_items(ref["grads"])]
    assert len(grads) == len(want)
    for (path, _), g, w in zip(tschema.tree_items(ref["grads"]), grads, want):
        assert np.isfinite(w).all() and torch.isfinite(g).all(), path
        assert rel_err(cpu(g), w) < GRAD_RTOL, path


@pytest.mark.parametrize("name", ARCHS)
def test_remat_changes_no_value(jax_side, name):
    """remat=True (each unit, encoder layer and xent chunk recomputed in the
    backward) against remat=False in the port, bit for bit."""
    ref = jax_side(f"grads:{name}")
    t1, m1, g1 = port_grads(ref, name, remat=True)
    t0, m0, g0 = port_grads(ref, name, remat=False)
    assert torch.equal(t1, t0) and torch.equal(m1["aux"], m0["aux"])
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The train step against the JAX package
# ---------------------------------------------------------------------------


def port_steps(name, ocfg, ref, microbatches=1):
    """The port's steps, each from the JAX state before it (carried by
    ``train_step.from_numpy``), on the JAX step's batch."""
    cfg = tconfigs.make_smoke(tconfigs.get_config(name))
    step = tts.make_train_step(cfg, ocfg, microbatches=microbatches)
    out = []
    for before, batch in zip(ref["states"], ref["batches"]):
        state = tts.from_numpy(cfg, ocfg, before, device="cpu")
        out.append(step(state, {k: torch.from_numpy(v) for k, v in batch.items()}))
    return out


QUANTUM = 1 / 127  # one int8 step of a leaf's largest gradient


def check_step(got, metrics, want, want_metrics, first: bool, compressed=False):
    """A step from the reference's state: loss, grad_norm, lr, step, the
    params (``step_params_close``; its tight part for a step from zero
    moments) and the moments.  Under compression one element's int8 value
    may differ by a quantum, which moves its moments by that much."""
    lr = float(want_metrics["lr"])
    assert rel_err(cpu(metrics["loss"]), want_metrics["loss"]) < RTOL
    assert rel_err(cpu(metrics["grad_norm"]), want_metrics["grad_norm"]) < GRAD_RTOL
    np.testing.assert_allclose(cpu(metrics["lr"]), want_metrics["lr"], rtol=1e-6, atol=0)
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == int(want.opt.step)
    q = 1.01 * QUANTUM if compressed else 0.0
    step_params_close(got.params, want.params, want.opt.mu if first else None, lr,
                      well_above=max(2 * GRAD_RTOL, 2 * q))
    for g, w in zip(leaves(got.opt.mu), leaves(want.opt.mu)):
        assert rel_err(cpu(g), w) < GRAD_RTOL + q
    for g, w in zip(leaves(got.opt.nu), leaves(want.opt.nu)):
        assert rel_err(cpu(g), w) < 2 * (GRAD_RTOL + q)


def test_train_step_microbatches_match_jax(jax_side):
    """``make_train_step(microbatches=2)`` at B = 4: the two halves'
    gradients summed in float32, then AdamW; loss the halves' mean."""
    ref = jax_side("microbatches")
    ocfg = toptim.OptConfig()
    (state, metrics), = port_steps("qwen3-8b", ocfg, ref, microbatches=2)
    check_step(state, metrics, ref["states"][1], ref["metrics"][0], first=True)


def test_compressed_training_matches_single_device_jax(jax_side):
    """test_distributed.py's compressed case (int8 error feedback, 3 steps
    at 8 x 64) against the JAX package's single-device step, each step
    from the reference's state before it."""
    ref = jax_side("compressed")
    ocfg = toptim.OptConfig(**COMPRESSED)
    for i, (state, metrics) in enumerate(port_steps("mamba2-130m", ocfg, ref)):
        assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
        check_step(state, metrics, ref["states"][i + 1], ref["metrics"][i], first=i == 0,
                   compressed=True)
        for g, w in zip(leaves(state.opt.ef_error), leaves(ref["states"][i + 1].opt.ef_error)):
            # each leaf's residual lies within half a quantum; its largest
            # value reaches that bound in both packages
            assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
            want_max = float(np.max(np.abs(w.astype(np.float32))))
            assert abs(float(g.abs().max()) - want_max) <= 0.02 * want_max


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def test_train_driver_end_to_end(jax_side, tmp_path):
    """test_system.py's train test on the port: 8 steps with a checkpoint
    every 4, then a resume to 10; the pipeline's counters after each run
    equal the JAX driver's."""
    from repro_torch.launch import train as ttrain

    rcs, counters = _driver_counters(
        ttrain, driver_runs(str(tmp_path / "ckpt"), ("--device", "cpu")))
    want_rcs, want = jax_side("driver")
    assert rcs == want_rcs == [0, 0]
    assert counters == want
    assert counters[1][0] > counters[0][0]


# ---------------------------------------------------------------------------
# The cross entropy and the optimizer
# ---------------------------------------------------------------------------


def test_streamed_xent_chunks_and_masks():
    """The chunk halves until it divides S (S = 24 with chunk 256 takes 24,
    with chunk 16 takes 8); a masked target adds nothing; the sum equals a
    plain cross entropy over the full logits."""
    cfg = tconfigs.make_smoke(tconfigs.get_config("qwen3-8b"))
    rng = np.random.default_rng(5)
    params = {"lm_head": torch.from_numpy(
        rng.normal(size=(cfg.d_model, cfg.vocab_size)).astype(np.float32) * 0.1)}
    x = torch.from_numpy(rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
    t[1, 5:9] = -1
    logits = (x @ params["lm_head"]).float()
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), t.reshape(-1).long(), ignore_index=-1,
        reduction="sum")
    for chunk in (256, 16, 5):
        nll, ntok = tmodel._streamed_xent(params, cfg, x, t, chunk=chunk)
        assert float(ntok) == 44
        assert rel_err(cpu(nll), want.numpy()) < RTOL


# ---------------------------------------------------------------------------
# The optimizer on identical gradients
# ---------------------------------------------------------------------------


def _opt_inputs(seed=4):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(64, 33)).astype(np.float32),
              "b": {"s": rng.normal(size=(7,)).astype(np.float32)}}
    grads = [{k: (rng.normal(size=np.shape(v)) * 0.3).astype(np.float32)
              if not isinstance(v, dict) else
              {"s": (rng.normal(size=(7,)) * 0.3).astype(np.float32)}
              for k, v in params.items()} for _ in range(3)]
    grads[0]["w"][0, :4] = [0.0, 1e-9, -1e-9, 2.5]
    return params, grads


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _as_torch(tree):
    """Nested dicts of numpy or JAX arrays as tensors, bfloat16 by its bits."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    return tschema.tree_map(one, tree)


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("variant", ["float32", "bf16_moments", "compressed"])
def test_optimizer_apply_matches_jax(variant):
    """Three AdamW steps of ``optim.apply`` on the same gradients in both
    packages, each step's port state carried from the JAX state before it."""
    kw = {"bf16_moments": dict(opt_dtype="bfloat16"),
          "compressed": dict(compress_grads=True)}.get(variant, {})
    params, grads = _opt_inputs()
    jc, tc = joptim.OptConfig(warmup_steps=2, total_steps=10, **kw), \
        toptim.OptConfig(warmup_steps=2, total_steps=10, **kw)
    jp, jo = _as_jax(params), joptim.init(_as_jax(params), jc)
    japply = jax.jit(joptim.apply, static_argnums=3)
    for g in grads:
        to = toptim.OptState(
            mu=_as_torch(jo.mu), nu=_as_torch(jo.nu),
            step=torch.tensor(int(jo.step), dtype=torch.int32),
            ef_error=None if jo.ef_error is None else _as_torch(jo.ef_error))
        tp2, to2, tm = toptim.apply(_as_torch(jp), _as_torch(g), to, tc)
        jp, jo, jm = japply(jp, _as_jax(g), jo, jc)
        assert int(to2.step) == int(jo.step) and to2.step.dtype == torch.int32
        np.testing.assert_allclose(_np(tm["lr"]), np.asarray(jm["lr"]), rtol=1e-6, atol=0)
        assert rel_err(_np(tm["grad_norm"]), np.asarray(jm["grad_norm"])) < 1e-6
        for got, want in zip(leaves(tp2), jax.tree.leaves(jp)):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
        for name in ("mu", "nu"):
            for got, want in zip(leaves(getattr(to2, name)), jax.tree.leaves(getattr(jo, name))):
                assert got.dtype == getattr(torch, tc.opt_dtype)
                w = np.asarray(want, np.float32)
                if variant == "bf16_moments":
                    np.testing.assert_allclose(_np(got), w, rtol=2**-7, atol=0)
                else:
                    assert rel_err(_np(got), w) < 1e-5
        if variant == "compressed":
            for got, want in zip(leaves(to2.ef_error), jax.tree.leaves(jo.ef_error)):
                assert got.dtype == torch.bfloat16
                np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                           rtol=2**-7, atol=2e-3)
        else:
            assert to2.ef_error is None


def test_optimizer_pieces_change_no_value(monkeypatch):
    """``apply`` and ``compress_int8`` over pieces of a leaf (``_PIECE``
    elements at a time, set here to 100, a remainder included) equal one
    pass over the whole leaf, bit for bit."""
    params, grads = _opt_inputs()
    ocfg = toptim.OptConfig(warmup_steps=2, total_steps=10, compress_grads=True)
    runs = []
    for piece in (1 << 26, 100):
        monkeypatch.setattr(toptim, "_PIECE", piece)
        p, o = _as_torch(params), toptim.init(_as_torch(params), ocfg)
        for g in grads:
            p, o, m = toptim.apply(p, _as_torch(g), o, ocfg)
        runs.append(leaves((p, o, m)))
    assert len(toptim._pieces(64 * 33)) == 22
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_compress_int8_matches_jax():
    """The int8 quantize-dequantize and its bf16 residual: each value
    within one quantum (scale) of the reference's, nearly all equal."""
    rng = np.random.default_rng(9)
    g = (rng.normal(size=(4096,)) * 0.02).astype(np.float32)
    g[:3] = [0.0, 1e-12, -0.08]
    err = (rng.normal(size=(4096,)) * 1e-4).astype(np.float32)
    jd, je = joptim.compress_int8(jnp.asarray(g), jnp.asarray(err, jnp.bfloat16))
    td, te = toptim.compress_int8(torch.from_numpy(g), torch.from_numpy(err).bfloat16())
    scale = max(np.abs(g + np.asarray(jnp.asarray(err, jnp.bfloat16), np.float32)).max(),
                1e-12) / 127
    d = np.abs(_np(td) - np.asarray(jd))
    assert td.dtype == torch.float32 and te.dtype == torch.bfloat16
    assert np.all(d <= scale * (1 + 1e-6)) and np.mean(d == 0) > 0.99
    assert np.all(np.abs(_np(te) - np.asarray(je, np.float32)) <= scale * 1.01 + 1e-6)


def test_schedule_matches_jax():
    for ocfg in (toptim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100),
                 toptim.OptConfig(lr=3e-4, warmup_steps=1, total_steps=8)):
        jc = joptim.OptConfig(lr=ocfg.lr, warmup_steps=ocfg.warmup_steps,
                              total_steps=ocfg.total_steps)
        for step in range(0, ocfg.total_steps + 3):
            want = np.float32(joptim.schedule(jc, jnp.int32(step)))
            got = toptim.schedule(ocfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(np.float32(got), want, rtol=1e-6, atol=0)
            assert float(toptim.schedule(ocfg, step)) == pytest.approx(float(want), rel=1e-6)


# ports of tests/test_infra.py::TestOptimizer


def test_adamw_reduces_loss():
    ocfg = toptim.OptConfig(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = toptim.init(params, ocfg)
    for _ in range(50):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w**2), [w])
        params, opt, _ = toptim.apply(params, {"w": g}, opt, ocfg)
    assert float(torch.sum(params["w"] ** 2)) < 0.1


def test_bf16_moments():
    ocfg = toptim.OptConfig(opt_dtype="bfloat16")
    params = {"w": torch.ones((4, 4))}
    opt = toptim.init(params, ocfg)
    assert opt.mu["w"].dtype == torch.bfloat16
    p2, _, _ = toptim.apply(params, {"w": torch.full((4, 4), 0.1)}, opt, ocfg)
    assert torch.isfinite(p2["w"]).all()


def test_grad_compression_error_feedback():
    """EF-int8 compression: biased per step, but the residual carries the
    error, so the mean update converges to the true gradient."""
    g = torch.tensor([1e-4, 0.5, -0.3, 2.0])
    err = torch.zeros(4, dtype=torch.bfloat16)
    total = torch.zeros(4)
    for _ in range(64):
        deq, err = toptim.compress_int8(g, err)
        total = total + deq
    np.testing.assert_allclose((total / 64).numpy(), g.numpy(), rtol=0.05, atol=1e-4)


def test_schedule_warmup_and_decay():
    ocfg = toptim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(toptim.schedule(ocfg, 5)) == pytest.approx(0.5)
    assert float(toptim.schedule(ocfg, 10)) == pytest.approx(1.0)
    assert float(toptim.schedule(ocfg, 100)) == pytest.approx(0.1, abs=0.01)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", tconfigs.ARCHS)
def test_one_train_step(name):
    """tests/test_archs.py::test_one_train_step on the port: a finite loss
    and gradients, a positive gradient norm, and a finite loss after a
    small SGD step."""
    cfg = tconfigs.make_smoke(tconfigs.get_config(name))
    params = tmodel.init(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    flat = [t.requires_grad_(True) for t in leaves(params)]
    total, _ = tmodel.loss_fn(tschema.tree_unflatten(params, flat), cfg, batch, remat=True)
    grads = torch.autograd.grad(total, flat)
    assert torch.isfinite(total)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    assert torch.isfinite(gnorm) and float(gnorm) > 0
    new = [(p - 1e-3 * g).detach() for p, g in zip(flat, grads)]
    loss2, _ = tmodel.loss_fn(tschema.tree_unflatten(params, new), cfg, batch, remat=False)
    assert torch.isfinite(loss2)


def test_train_with_compression_and_microbatches(tmp_path):
    from repro_torch.launch import train as ttrain

    rc = ttrain.main(["--arch", "qwen3-8b", "--smoke", "--steps", "4", "--batch", "4",
                      "--seq", "32", "--microbatches", "2", "--compress-grads",
                      "--device", "cpu"])
    assert rc == 0


def test_driver_beats_its_heartbeat(monkeypatch):
    """The driver's one host beats its heartbeat after every step, so a run
    longer than ``FTConfig``'s 30 s heartbeat timeout goes on.  Each step
    here takes 25 s of a fake clock.  The JAX package's driver beats none
    and halts such a run (``RuntimeError: cluster below
    min_data_parallel``; ROADMAP Queue 3); its side is not called."""
    from repro_torch.launch import train as ttrain

    now = [0.0]
    make_monitor, make_step = ttrain.ClusterMonitor, ttrain.ts.make_train_step

    def slow_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch):
            now[0] += 25.0
            return step(state, batch)

        return run

    monkeypatch.setattr(ttrain, "ClusterMonitor",
                        lambda hosts, cfg: make_monitor(hosts, cfg, clock=lambda: now[0]))
    monkeypatch.setattr(ttrain.ts, "make_train_step", slow_step)
    assert ttrain.main(["--arch", "mamba2-130m", "--smoke", "--steps", "4", "--batch", "2",
                        "--seq", "32", "--device", "cpu"]) == 0
    assert now[0] == 100.0
