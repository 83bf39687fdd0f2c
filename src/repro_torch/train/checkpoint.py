"""Sharded, atomic, async checkpointing with elastic restore.

The port of ``repro.train.checkpoint``, with the JAX package's file
layout leaf for leaf:

    <dir>/step_<N>/
        manifest.json        tree structure, shapes, dtypes, digests
        shard_0.npz          leaf_<i>: the i-th leaf in jax.tree_util order
        pipeline.npz         data-pipeline + dedup-filter state
    <dir>/LATEST             atomic pointer (written last)

Leaves are flattened as ``jax.tree_util`` flattens the reference's
state (dict keys sorted, ``NamedTuple`` fields in order, a ``None``
field no leaf), so ``leaf_i`` names the same leaf in both packages and a
checkpoint written by either restores in the other.  A bfloat16 leaf is
written as the JAX package's files hold it, the two-byte ``|V2`` view of
its bits with ``"bfloat16"`` in the manifest, so its digest is over the
same bytes; on restore the manifest's dtype turns a ``|V2`` leaf back
into bfloat16 (the reference's own restore cannot read that leaf).

* atomicity: the step is written to a temp dir, fsync'd, then one
  rename publishes it; LATEST updates only after the rename.
* async: ``save(..., background=True)`` copies the state to host memory,
  then writes on a worker thread (one save outstanding).
* placed state (DTensors): every rank gathers each leaf whole
  (``full_tensor``), rank 0 writes the same bytes as for a plain state,
  and the ranks meet at a barrier once the write is done.
* elastic restore: leaves are saved whole; ``restore`` checks each
  partition spec against its leaf and places it on the mesh: as
  DTensors by the specs on a mesh with a ``DeviceMesh`` (of any shape,
  whatever mesh saved them), on the mesh's device otherwise.
* retention (keep_last_k) and integrity (digests verified on restore).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import sharding as shd
from ..core.quotient_filter import resolve_device
from ..models.schema import tree_leaves, tree_unflatten

_BF16_FILE = np.dtype("V2")  # what np.savez of an ml_dtypes bfloat16 array holds


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def _to_host(t: torch.Tensor) -> tuple:
    """(numpy array as the JAX package's file holds it, manifest dtype); a
    DTensor gathered whole first (a collective)."""
    t = shd.whole(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_FILE), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _structure(tree) -> str:
    """A readable outline of the tree: its containers with ``*`` leaves."""
    return repr(tree_unflatten(tree, ["*"] * len(tree_leaves(tree))))


class CheckpointManager:
    def __init__(self, directory: str, keep_last_k: int = 3):
        self.dir = directory
        self.keep = keep_last_k
        os.makedirs(directory, exist_ok=True)
        self._worker: Optional[threading.Thread] = None
        self._barrier = False  # a placed save's ranks still to meet

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state, extra: Optional[dict] = None, *,
             background: bool = False) -> None:
        """Write ``state``; of a placed state every rank calls this, and
        only rank 0 writes.  With ``background`` the ranks meet at
        :meth:`wait` (which every rank calls), else before this returns."""
        self.wait()  # one outstanding save at a time
        leaves = tree_leaves(state)
        placed = any(shd.is_placed(x) for x in leaves)
        # snapshot to host memory synchronously (cheap vs device compute)
        host = [_to_host(x) for x in leaves]
        extra_host = None
        if extra is not None:
            extra_host = {k: np.asarray(v) for k, v in extra.items()}
        structure = _structure(state)
        self._barrier = placed
        if not placed or dist.get_rank() == 0:
            if background:
                self._worker = threading.Thread(
                    target=self._write, args=(step, host, structure, extra_host)
                )
                self._worker.start()
            else:
                self._write(step, host, structure, extra_host)
        if not background:
            self.wait()

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _write(self, step, host, structure, extra_host) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            manifest = {
                "step": step,
                "treedef": structure,
                "n_leaves": len(host),
                "leaves": [
                    {"shape": list(a.shape), "dtype": dtype, "digest": _digest(a)}
                    for a, dtype in host
                ],
            }
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
            if extra_host is not None:
                np.savez(os.path.join(tmp, "pipeline.npz"), **extra_host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            with open(os.path.join(self.dir, ".LATEST.tmp"), "w") as f:
                f.write(os.path.basename(final))
                f.flush()
                os.fsync(f.fileno())
            os.rename(
                os.path.join(self.dir, ".LATEST.tmp"),
                os.path.join(self.dir, "LATEST"),
            )
            self._gc()
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _gc(self) -> None:
        steps = sorted(
            d for d in os.listdir(self.dir) if d.startswith("step_")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, step: int, like, *, shardings=None, verify: bool = True,
                device=None):
        """Restore into the structure of ``like`` (on the ``meta`` device,
        or concrete) on ``device`` (the card unless asked).

        ``shardings``: (mesh, spec tree), the spec tree (tuples) matching
        ``like``, as ``train_step.state_pspecs`` gives it.  Each spec must
        divide its leaf, as placement on a mesh demands, and the leaves go
        to the mesh, whatever the topology of the mesh that saved them:
        DTensors placed by their specs where the mesh has a ``DeviceMesh``
        (every rank calls this and reads the whole file), else on the
        mesh's device."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_meta = manifest["leaves"]
        like_leaves = tree_leaves(like)
        if len(like_leaves) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, "
                f"target structure has {len(like_leaves)}"
            )
        if shardings is not None:
            mesh, spec_tree = shardings
            specs = tree_leaves(spec_tree, is_leaf=lambda x: type(x) is tuple)
            if len(specs) != len(like_leaves):
                raise ValueError(f"{len(specs)} specs for {len(like_leaves)} leaves")
            target = mesh.device
        else:
            specs = [None] * len(like_leaves)
            target = resolve_device(device)
        out = []
        with np.load(os.path.join(d, "shard_0.npz")) as data:
            for i, (meta, tgt, spec) in enumerate(zip(leaves_meta, like_leaves, specs)):
                arr = data[f"leaf_{i}"]
                if verify and _digest(arr) != meta["digest"]:
                    raise IOError(f"digest mismatch on leaf {i}: corrupt checkpoint")
                if list(arr.shape) != list(tgt.shape):
                    raise ValueError(
                        f"leaf {i}: checkpoint shape {arr.shape} != target {tuple(tgt.shape)}"
                    )
                if spec is not None:
                    cuts = shd.shards(mesh, spec)
                    if len(spec) > arr.ndim or any(
                        dim % n for dim, n in zip(arr.shape, cuts)
                    ):
                        raise ValueError(
                            f"leaf {i}: spec {spec} does not divide shape {arr.shape}"
                        )
                if meta["dtype"] == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr))
                out.append(t.to(target))
        if shardings is not None and mesh.device_mesh is not None:
            out = [shd.place(t, spec, mesh) for t, spec in zip(out, specs)]
        return tree_unflatten(like, out)

    def restore_extra(self, step: int) -> Optional[dict]:
        p = os.path.join(self.dir, f"step_{step:08d}", "pipeline.npz")
        if not os.path.exists(p):
            return None
        with np.load(p, allow_pickle=True) as data:
            return {k: data[k] for k in data.files}
