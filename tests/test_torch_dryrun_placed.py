"""The dry run placed on the production mesh (``launch/dryrun.py``), on
the CPU.

One subprocess opens the dry run's ``fake`` process group (``dryrun.
fake_group``, as a dry-run worker does) and runs every placed case;
pytest's own process never holds a group.

* ``StepMeter``'s collective bytes, kind by kind, equal the JAX
  package's ``repro.launch.roofline.collective_bytes`` read on the HLO
  line of the same collective (the output-shape convention): an
  all-gather, an all-reduce and a reduce-scatter of fixed bf16 and f32
  shapes, made by DTensor redistributions on a 16-device ``meta`` mesh;
  a CPU mesh's all-to-all (DTensor makes it an all-gather and a chunk)
  counts as the all-to-all an NCCL mesh runs, and as nothing else.
* Full-width configs, cut to one unit, at B = 32, S = 256, placed on the
  16 x 16 mesh by the sharding rules: the prefills of Qwen3-8B (8 KV
  heads), StarCoder2-15B (4 KV heads), Qwen2-VL-7B (28 heads) and
  Whisper-large-v3 (its encoder's 20 heads), Mamba2-130M's step (the
  SSD's 24 heads, forward and backward) and its step in 2 microbatches
  (a 32-row batch cut 16 ways, viewed as 2 x 16).  Each failed on the
  tree before the head views, the SSD's views and the microbatch split
  were repaired (DTensor cannot view a dim cut inside its leading
  part); each now ends with collectives of the kinds its placements
  call for, and the flops the DTensor level counts equal the unplaced
  run's exactly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro.launch import roofline as jrf
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ = 32, 256
# each case: (arch, step kind, microbatches)
CELLS = {
    "qwen3-8b": ("qwen3-8b", "prefill", 1),
    "starcoder2-15b": ("starcoder2-15b", "prefill", 1),
    "qwen2-vl-7b": ("qwen2-vl-7b", "prefill", 1),
    "whisper-large-v3": ("whisper-large-v3", "prefill", 1),
    "mamba2-130m": ("mamba2-130m", "train", 1),
    "mamba2-130m-microbatched": ("mamba2-130m", "train", 2),
}
# each kind: (global shape, dtype, placement before, after) on a 16-device
# mesh, and the HLO line the same collective prints on one device
KINDS = {
    "all-gather": ((16, 4096), "bfloat16", "Shard(0)", "Replicate()",
                   "%ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %p0), "
                   "replica_groups={}, dimensions={0}"),
    "all-reduce": ((64, 128), "float32", "Partial()", "Replicate()",
                   "%ar = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %p1), "
                   "replica_groups={}, to_apply=%add"),
    "reduce-scatter": ((64, 256), "bfloat16", "Partial()", "Shard(0)",
                       "%rs = bf16[4,256]{1,0} reduce-scatter(bf16[64,256]{1,0} %p2), "
                       "replica_groups={}, dimensions={0}, to_apply=%add"),
    "all-to-all": ((64, 32), "bfloat16", "Shard(0)", "Shard(1)",
                   "%a2a = bf16[64,2]{1,0} all-to-all(bf16[4,32]{1,0} %p3), "
                   "replica_groups={}, dimensions={1}"),
}
PROGRAM_TIMEOUT = 240

PROGRAM = r'''
import json, sys
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeSpec

cells, kinds, batch, seq = json.loads(sys.argv[2])
out = {"kinds": {}, "cells": {}}
with dryrun.fake_group(16):
    dm = shd.meta_mesh((16,), ("model",)).device_mesh
    for kind, (shape, dtype, src, dst, _) in kinds.items():
        shape, src, dst = tuple(shape), eval(src), eval(dst)
        local, _ = compute_local_shape_and_global_offset(shape, dm, [src])
        x = DTensor.from_local(torch.empty(local, dtype=getattr(torch, dtype), device="meta"),
                               dm, [src], run_check=False, shape=shape,
                               stride=(shape[1], 1))
        with dryrun.StepMeter(placed=True) as m:
            y = x.redistribute(dm, [dst])
        out["kinds"][kind] = {**m.collectives(), "local": list(y.to_local().shape)}
with dryrun.fake_group(256):
    mesh = shd.meta_mesh((16, 16), ("data", "model"))
    for name, (arch, kind, mb) in cells.items():
        cfg = dryrun.with_units(get_config(arch), 1)
        try:
            c = dryrun.measure(cfg, ShapeSpec(kind, kind, seq, batch), microbatches=mb, mesh=mesh)
            out["cells"][name] = {"status": "ok", **c}
        except Exception as e:
            out["cells"][name] = {"status": "error", "error": f"{type(e).__name__}: {e}"}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """The subprocess's results (its fake group ends with it), and each
    cell's unplaced flops, counted here while it runs."""
    out = tmp_path_factory.mktemp("placed")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    args = json.dumps([CELLS, KINDS, BATCH, SEQ])
    with open(out / "log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", PROGRAM, str(out / "out.json"), args],
                                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            plain = {name: dryrun.measure(dryrun.with_units(get_config(arch), 1),
                                          ShapeSpec(kind, kind, SEQ, BATCH),
                                          microbatches=mb)["flops"]
                     for name, (arch, kind, mb) in CELLS.items()}
            rc = proc.wait(timeout=PROGRAM_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert rc == 0, (out / "log").read_text()[-4000:]
    return {**json.loads((out / "out.json").read_text()), "plain_flops": plain}


@pytest.mark.parametrize("kind", list(KINDS))
def test_meter_bytes_are_the_references(placed, kind):
    """Each kind's bytes are ``collective_bytes``' on its HLO line, and no
    other kind is counted."""
    got = placed["kinds"][kind]
    want = jrf.collective_bytes(KINDS[kind][4])
    assert want[kind] > 0 and want["total"] == want[kind]
    assert {k: got[k] for k in want} == want
    assert got[f"calls:{kind}"] == 1
    assert sum(got[f"calls:{k}"] for k in dryrun.COLLECTIVES) == 1


def test_cpu_all_to_all_counts_as_one(placed):
    """DTensor's CPU path for Shard(0) -> Shard(1) is an all-gather and a
    chunk (``shard_dim_alltoall``): the meter counts one all-to-all of the
    chunk's bytes, the output an all-to-all leaves on a device, and no
    all-gather."""
    got = placed["kinds"]["all-to-all"]
    assert got["local"] == [64, 2]
    assert (got["all-to-all"], got["all-gather"], got["calls:all-gather"]) == (64 * 2 * 2, 0, 0)


@pytest.mark.parametrize("name", list(CELLS))
def test_full_width_cell_runs_placed(placed, name):
    """The placed step ends ``ok`` with collectives on the 16 x 16 mesh;
    its whole-step flops equal the unplaced run's."""
    got = placed["cells"][name]
    assert got["status"] == "ok", got.get("error")
    kind = CELLS[name][1]
    assert got["total"] > 0 and got["total"] == sum(got[k] for k in dryrun.COLLECTIVES)
    assert got["all-gather"] > 0 and got["calls:all-gather"] > 0
    if kind == "train":  # gradients of params cut over the data axes are reduced
        assert got["reduce-scatter"] + got["all-reduce"] > 0
    assert got["flops"] == placed["plain_flops"][name] > 0
