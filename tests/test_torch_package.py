"""Package rules of ``repro_torch``: no JAX inside, state on the card by default."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import filters as tf
from repro_torch.core import quotient_filter as tqf
from repro_torch.kernels import (
    bloom_block,
    cascade_probe,
    cuda_lib,
    fingerprint,
    fuse_probe,
    qf_build,
    qf_decode,
    qf_probe,
)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.filters, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.cuda_lib, repro_torch.kernels.bloom_block\n"
        "import repro_torch.core.bloom, repro_torch.core.bf_variants\n"
        "import repro_torch.filters.bloom_filter, repro_torch.filters.xor_fuse\n"
        "import repro_torch.core.fuse_filter, repro_torch.kernels.fuse_probe\n"
        "import repro_torch.kernels.fingerprint\n"
        "import repro_torch.filters.incremental_resize, repro_torch.filters.auto_scale\n"
        "import repro_torch.filters.steady, repro_torch.data.pipeline\n"
        "import repro_torch.serve.prefix_cache\n"
        "import repro_torch.core.buffered_qf, repro_torch.core.cascade_filter\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.serve.serve_step\n"
        "import repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


@pytest.mark.parametrize(
    "name",
    ["qf", "buffered_qf", "cascade", "bloom", "blocked_bloom", "frozen cascade",
     "xor_fuse", "steady_qf", "sharded_qf"],
)
def test_make_without_a_device_needs_a_card(name, monkeypatch):
    family, spec = {
        "qf": ("qf", dict(q=6, r=8)),
        "buffered_qf": ("buffered_qf", dict(ram_q=5, disk_q=7, p=20)),
        "cascade": ("cascade", dict(ram_q=5, p=20, levels=2)),
        "bloom": ("bloom", dict(m_bits=500, k=3, counting=True)),
        "blocked_bloom": ("blocked_bloom", dict(m_bits=1024, k=3, block_bits=256)),
        "frozen cascade": ("cascade", dict(ram_q=5, p=20, levels=2, frozen_below=1)),
        "xor_fuse": ("xor_fuse", dict(p=26, keys=np.arange(50, dtype=np.int32))),
        "steady_qf": ("steady_qf", dict(q=9, r=12)),
        "sharded_qf": ("sharded_qf", dict(q=8, r=16, n_shards=1)),
    }[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.make(family, **spec)
    cfg, state = tf.make(family, device="cpu", **spec)
    assert {str(t.device) for _, t in tf._leaves(state)} == {"cpu"}


@pytest.mark.parametrize("name", ["ebf", "bbf", "fbf"])
def test_baselines_without_a_device_need_a_card(name, monkeypatch):
    from repro_torch.core import bf_variants as bf
    from repro_torch.core import bloom

    make = {
        "ebf": lambda **d: bf.ElevatorBloomFilter(
            bloom.BloomConfig(m_bits=4096, k=3), buffer_capacity_bits=64, **d
        ),
        "bbf": lambda **d: bf.BufferedBloomFilter(
            bloom.BloomConfig(m_bits=4096, k=3), ram_bytes=256, block_bytes=64, **d
        ),
        "fbf": lambda **d: bf.ForestBloomFilter(
            bits_per_element=8, ram_bytes=64, total_elements=100, **d
        ),
    }[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    struct = make(device="cpu")
    struct.insert(np.arange(50, dtype=np.uint32))
    assert bool(struct.lookup(np.arange(50, dtype=np.uint32)).all())


def test_empty_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tqf.empty(tqf.QFConfig(q=4, r=4))


def test_keys_follow_the_state_onto_its_device():
    cfg, st = tf.make("qf", device="cpu", q=6, r=10)
    keys = np.arange(40, dtype=np.uint32) * np.uint32(2654435761)
    st = tf.insert(cfg, st, keys)
    assert tf.contains(cfg, st, keys).all()
    assert int(tf.stats(cfg, st)["n"]) == 40


# each kernel module's wrappers, with the plain versions beside them, and
# the JAX package's file that computes the same: a Pallas kernel's module,
# or (fingerprint) the XLA code of the key hash
KERNELS = {
    "qf_build": (
        qf_build,
        [("qf_build_planes", "build_planes_plain"), ("qf_positions", "positions_plain"),
         ("qf_build_span", "build_span_plain")],
        "repro/kernels/qf_build.py",
    ),
    "qf_probe": (qf_probe, [("qf_probe", "probe_plain")], "repro/kernels/qf_probe.py"),
    "cascade_probe": (cascade_probe, [("cascade_probe", "cascade_probe_plain")],
                      "repro/kernels/cascade_probe.py"),
    "bloom_block": (
        bloom_block,
        [("bloom_count", "bloom_count_plain"), ("bloom_probe", "bloom_probe_plain")],
        "repro/kernels/bloom_block.py",
    ),
    "fuse_probe": (fuse_probe, [("fuse_probe", "fuse_probe_plain")],
                   "repro/kernels/fuse_probe.py"),
    "fingerprint": (fingerprint, [("fingerprint", "fingerprint_plain")],
                    "repro/core/fingerprint.py"),
    "qf_decode": (qf_decode, [("qf_decode", "decode_plain")],
                  "repro/core/quotient_filter.py"),
}
# the JAX package's file each CUDA source computes
CSRC = {
    "qf_build": "repro/kernels/qf_build.py",
    "qf_probe": "repro/kernels/qf_probe.py",
    "cascade_probe": "repro/kernels/cascade_probe.py",
    "bloom_count": "repro/kernels/bloom_block.py",
    "bloom_probe": "repro/kernels/bloom_block.py",
    "fuse_probe": "repro/kernels/fuse_probe.py",
    "fingerprint": "repro/core/fingerprint.py",
    "qf_decode": "repro/core/quotient_filter.py",
}


@pytest.mark.parametrize("module", sorted(KERNELS))
def test_kernel_module_has_plain_version_and_launch_counter(module):
    mod, pairs, jax_file = KERNELS[module]
    for wrapper, plain in pairs:
        assert callable(getattr(mod, plain))
        assert isinstance(getattr(mod, wrapper).launches, int)
    assert jax_file in mod.__doc__  # names the JAX code it replaces


def test_csrc_holds_the_six_sources_cuda_lib_builds():
    # seven since the fingerprint kernel joined the six Pallas kernels' ports,
    # eight since the decode kernel
    sources = sorted(p.stem for p in cuda_lib.CSRC.glob("*.cu"))
    assert sources == sorted(cuda_lib.SOURCES) == sorted(CSRC)
    for name in sources:  # a plain C entry point, and the JAX code it computes
        text = (cuda_lib.CSRC / f"{name}.cu").read_text()
        assert 'extern "C" int ' in text and CSRC[name] in text


def test_core_exports_what_the_jax_package_exports():
    import repro.core
    import repro_torch.core
    from repro_torch.core import buffered_qf, cascade_filter

    assert repro_torch.core.__all__ == repro.core.__all__
    for name in repro_torch.core.__all__:
        assert hasattr(repro_torch.core, name), name
    # each shim names the JAX file it ports
    assert "repro/core/buffered_qf.py" in buffered_qf.__doc__
    assert "repro/core/cascade_filter.py" in cascade_filter.__doc__


@pytest.mark.parametrize("device, backend", [("cpu", "reference"), ("cuda", "pallas")])
def test_one_rule_picks_the_backend_by_device(device, backend):
    """The shims, the dedup pipeline and the sharded family take their
    backend from ``dispatch.backend_for``: the kernel path on the card."""
    from repro_torch.core import buffered_qf, cascade_filter
    from repro_torch.data import pipeline
    from repro_torch.filters import sharded
    from repro_torch.kernels import dispatch

    assert dispatch.backend_for(torch.device(device)) == backend
    for module in (buffered_qf, cascade_filter, pipeline, sharded):
        assert module.dispatch is dispatch, module.__name__


@pytest.mark.parametrize("name", ["BufferedQuotientFilter", "CascadeFilter"])
def test_shims_without_a_device_need_a_card(name, monkeypatch):
    import repro_torch.core as core

    make = {
        "BufferedQuotientFilter": lambda **d: core.BufferedQuotientFilter(
            tqf.QFConfig(q=5, r=15), tqf.QFConfig(q=7, r=13), **d
        ),
        "CascadeFilter": lambda **d: core.CascadeFilter(ram_q=5, p=20, **d),
    }[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    struct = make(device="cpu")
    keys = np.arange(50, dtype=np.uint32)
    struct.insert(keys)
    assert bool(struct.lookup(keys).all()) and struct.count == 50
