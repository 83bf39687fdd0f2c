"""Streaming data pipeline with AMQ deduplication.

The port of ``repro.data.pipeline``, the paper's application layer (§1
"Applications"): every incoming document's digest is checked against,
and inserted into, an AMQ before tokenization, and duplicates (or
probable duplicates, at the filter's fp rate) are dropped.  The filter
state checkpoints with the pipeline.

Stages: synthetic corpus -> digest -> dedup filter -> tokenize (hash
stub) -> pack to fixed-length rows -> global batch.  The filter lives on
the pipeline's device (the card unless ``device="cpu"``), and batches
are int32 tensors there.  The device also picks the filter's backend:
``"pallas"`` (the CUDA kernels) on the card, ``"reference"`` (the plain
path, which the JAX pipeline runs by default) on the CPU; both give the
same states bit for bit.  A snapshot's filter leaves are
``filters.to_numpy``'s, the JAX pipeline's leaves, so a snapshot of
either package restores into the other once its config is given as the
other package's config type.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from .. import filters
from ..core import quotient_filter as qf
from ..kernels import dispatch


@dataclass
class PipelineConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    batch_size: int = 8
    dedup_family: str = "cascade"  # any registry family ("cascade", "qf", ...)
    dedup_ram_q: int = 16  # Q0 buckets of the cascade filter (q for "qf")
    dedup_p: int = 30  # fingerprint bits (fp rate ~ n * 2^-p)
    dedup_fanout: int = 4
    dedup_levels: int = 3  # static disk-level depth of the cascade
    dedup_chunk: int = 1024  # incremental-migration / settle chunk (qf, steady_qf)
    # cascade cold-tier demotion: depth below which merged-down levels
    # freeze into binary-fuse form; "auto" asks the cost model
    # (``cost_model.recommend_frozen_below``), None keeps all-QF levels.
    # Frozen dedup filters cannot delete, which this pipeline never does.
    dedup_frozen_below: "int | str | None" = None
    duplicate_fraction: float = 0.3  # synthetic corpus duplication rate
    doc_len_range: tuple = (64, 512)
    seed: int = 0

    def dedup_spec(self) -> dict:
        if self.dedup_family == "cascade":
            spec = dict(
                ram_q=self.dedup_ram_q,
                p=self.dedup_p,
                fanout=self.dedup_fanout,
                levels=self.dedup_levels,
            )
            fb = self.dedup_frozen_below
            if fb == "auto":
                from ..core import cost_model

                fb = cost_model.recommend_frozen_below(
                    self.dedup_ram_q,
                    self.dedup_p,
                    fanout=self.dedup_fanout,
                    levels=self.dedup_levels,
                )
            if fb is not None:
                spec["frozen_below"] = fb
            return spec
        if self.dedup_family == "qf":
            return dict(q=self.dedup_ram_q, r=self.dedup_p - self.dedup_ram_q)
        if self.dedup_family == "steady_qf":
            # steady-state ingest: O(buffer) inserts, settle ticks bounded
            # by the chunk
            return dict(
                q=self.dedup_ram_q,
                r=self.dedup_p - self.dedup_ram_q,
                chunk=self.dedup_chunk,
            )
        raise ValueError(f"no dedup spec mapping for {self.dedup_family!r}")


@dataclass
class PipelineState:
    docs_seen: int = 0
    docs_kept: int = 0
    docs_dropped: int = 0
    token_backlog: list = field(default_factory=list)


class SyntheticCorpus:
    """Deterministic document stream with injected duplicates (the
    Webtable-style crawl in miniature); numpy, as in the JAX package."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._originals: list[int] = []

    def batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (doc_ids uint32, is_dup bool) for n documents."""
        ids = np.empty(n, np.uint32)
        dup = np.zeros(n, bool)
        for i in range(n):
            if self._originals and self.rng.random() < self.cfg.duplicate_fraction:
                ids[i] = self.rng.choice(self._originals[-10_000:])
                dup[i] = True
            else:
                new = np.uint32(self.rng.integers(0, 2**32, dtype=np.uint64))
                ids[i] = new
                self._originals.append(int(new))
        return ids, dup

    def tokens_for(self, doc_id: int) -> np.ndarray:
        """Stub tokenizer: deterministic token stream from the digest."""
        r = np.random.default_rng(int(doc_id))
        n = r.integers(*self.cfg.doc_len_range)
        return r.integers(1, self.cfg.vocab_size, size=n, dtype=np.int32)


class DedupPipeline:
    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.device = qf.resolve_device(device)
        self.corpus = SyntheticCorpus(cfg)
        self.filter_cfg, self.filter_state = filters.make(
            cfg.dedup_family, device=self.device,
            backend=dispatch.backend_for(self.device), **cfg.dedup_spec()
        )
        self.state = PipelineState()

    def _keys(self, doc_ids: np.ndarray) -> torch.Tensor:
        """uint32 digests as the int32 bit patterns the filters hash."""
        ids = np.ascontiguousarray(doc_ids, np.uint32).view(np.int32)
        return torch.from_numpy(ids.copy()).to(self.device)

    def _dedup(self, doc_ids: np.ndarray) -> np.ndarray:
        """Returns the keep-mask; inserts the kept digests into the filter.

        Also dedups within the incoming batch (first occurrence wins).
        The insert takes a padded batch of the incoming size with a valid
        count.  Ingest goes through ``filters.auto_scale``: growth is
        incremental where the family supports it (mid-migration the
        cfg/state pair is the migrating wrapper, and a snapshot taken
        then restores and resumes the migration), a cascade deepens in
        place, and the low watermark shrinks the filter after deletes."""
        keys = self._keys(doc_ids)
        seen = filters.contains(self.filter_cfg, self.filter_state, keys).cpu().numpy()
        _, first_idx = np.unique(doc_ids, return_index=True)
        first_occurrence = np.zeros(len(doc_ids), bool)
        first_occurrence[first_idx] = True
        keep = (~seen) & first_occurrence
        if keep.any():
            kept = doc_ids[keep]
            padded = np.zeros(len(doc_ids), np.uint32)
            padded[: len(kept)] = kept
            self.filter_cfg, self.filter_state = filters.auto_scale(
                self.filter_cfg,
                self.filter_state,
                self._keys(padded),
                k=int(keep.sum()),
                chunk=self.cfg.dedup_chunk,
            )
        return keep

    def batches(self, n_batches: int, docs_per_step: int = 256) -> Iterator[dict]:
        """Yields training batches of packed token rows (int32 tensors on
        the pipeline's device)."""
        cfg = self.cfg
        need = cfg.seq_len * cfg.batch_size + 1
        backlog = self.state.token_backlog
        for _ in range(n_batches):
            while sum(len(t) for t in backlog) < need:
                ids, _ = self.corpus.batch(docs_per_step)
                keep = self._dedup(ids)
                self.state.docs_seen += len(ids)
                self.state.docs_kept += int(keep.sum())
                self.state.docs_dropped += int((~keep).sum())
                for d in ids[keep]:
                    backlog.append(self.corpus.tokens_for(int(d)))
            flat = np.concatenate(backlog)
            take = flat[:need]
            rest = flat[need - 1 :]  # keep one-token overlap for targets
            self.state.token_backlog = [rest]
            backlog = self.state.token_backlog
            rows = take[: cfg.seq_len * cfg.batch_size].reshape(
                cfg.batch_size, cfg.seq_len
            )
            tgts = take[1 : cfg.seq_len * cfg.batch_size + 1].reshape(
                cfg.batch_size, cfg.seq_len
            )
            yield {
                "tokens": torch.from_numpy(rows.astype(np.int32)).to(self.device),
                "targets": torch.from_numpy(tgts.astype(np.int32)).to(self.device),
            }

    # -- checkpointable state ------------------------------------------------

    def snapshot(self) -> dict:
        """Counters, the filter config and the filter state as the JAX
        package's pytree leaves (numpy arrays; pickles cleanly).

        The config rides along because ``auto_scale`` may have grown,
        shrunk or begun migrating the structure since construction: a
        restore must rebuild the current geometry, an in-flight migration
        included."""
        return {
            "docs_seen": self.state.docs_seen,
            "docs_kept": self.state.docs_kept,
            "docs_dropped": self.state.docs_dropped,
            "filter_cfg": self.filter_cfg,
            "filter_leaves": filters.to_numpy(self.filter_cfg, self.filter_state),
        }

    def restore(self, snap: dict) -> None:
        """Restore a snapshot; refuses (ValueError) leaves that do not fit
        its config, and then leaves the pipeline as it was."""
        cfg = snap.get("filter_cfg")
        if cfg is None:
            cfg = self.filter_cfg
        elif not hasattr(cfg, "_fields"):
            # legacy snapshots stored tuple(cfg): reconstruct as this
            # pipeline's config type
            cfg = type(self.filter_cfg)(*cfg)
        try:
            # the whole state is built before self is touched, so an
            # invalid snapshot cannot leave the pipeline half-restored
            state = filters.from_numpy(cfg, snap["filter_leaves"], device=self.device)
        except (TypeError, ValueError) as e:
            raise ValueError(
                "snapshot filter state does not match this pipeline's dedup "
                f"config (family/geometry changed?): refusing to restore ({e})"
            ) from e
        self.state.docs_seen = int(snap["docs_seen"])
        self.state.docs_kept = int(snap["docs_kept"])
        self.state.docs_dropped = int(snap["docs_dropped"])
        self.filter_cfg, self.filter_state = cfg, state
