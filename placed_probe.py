"""Every arch's placed step at a short shape, on this host's torch: the dry
run's placed meshes (``launch/dryrun.py``) at one unit, train and prefill at
B = 32, S = 3,072 (the chunked attention path), decode at its cell's shape,
each in a spawned worker with its own ``fake`` process group.  Prints one
JSON line a run (``ok`` and its collective bytes, or the error, the failing
op and the port's innermost frames) and writes them to
``chiprun_out/placed_probe.json``.  A placement change is proved on the
card's host this way before a whole grid: its torch's DTensor fails where
another version passes.

  python placed_probe.py   # here, and on the H100's host
"""
import json
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed
from multiprocessing import get_context
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))


def task(t):
    arch, kind, B, S, mesh_name = t
    import torch
    torch.set_num_threads(1)
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec
    mesh = dryrun.MESHES[mesh_name]()
    cfg = dryrun.with_units(get_config(arch), 1)
    mb = dryrun.DRYRUN_OVERRIDES.get(arch, {}).get("microbatches", 1) if kind == "train" else 1
    t0 = time.perf_counter()
    try:
        with dryrun.fake_group(mesh.size):
            m = shd.meta_mesh(tuple(mesh.shape.values()), mesh.axis_names, dryrun.DEVICE_AXES.get(mesh_name))
            c = dryrun.measure(cfg, ShapeSpec(kind, kind, S, B), microbatches=mb, mesh=m)
        return [t, "ok", round(time.perf_counter() - t0, 1), c.get("total")]
    except Exception as e:
        tb = traceback.extract_tb(e.__traceback__)
        ours = [f"{Path(f.filename).name}:{f.lineno} {f.line}" for f in tb if "repro_torch" in f.filename]
        msg = str(e)
        op = msg.split("Sharding propagation failed for ")[-1][:200] if "propagation" in msg else ""
        return [t, "FAIL", round(time.perf_counter() - t0, 1), f"{type(e).__name__}: {msg.splitlines()[0][:200]}", op, ours[-3:]]


if __name__ == "__main__":
    import torch
    print(sys.version, torch.__version__, flush=True)
    from repro_torch.configs import ARCHS
    tasks = []
    for a in ARCHS:
        tasks += [(a, "train", 32, 3072, "16x16"), (a, "prefill", 32, 3072, "16x16"),
                  (a, "decode", 128, 32768, "16x16")]
        if a in ("mamba2-130m", "recurrentgemma-9b"):
            tasks.append((a, "decode", 1, 524288, "16x16"))
    tasks += [("qwen3-8b", "decode", 128, 32768, "2x16x16"), ("mamba2-130m", "train", 32, 3072, "2x16x16")]
    out = []
    with ProcessPoolExecutor(6, mp_context=get_context("spawn")) as pool:
        for f in as_completed([pool.submit(task, t) for t in tasks]):
            r = f.result()
            out.append(r)
            print(json.dumps(r), flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/placed_probe.json").write_text(json.dumps(out, indent=1))
    print("FAILS", sum(r[1] == "FAIL" for r in out), "OF", len(out))
