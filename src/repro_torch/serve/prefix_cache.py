"""AMQ-fronted prefix cache (the paper's Webtable pattern, serving-side).

The port of ``repro.serve.prefix_cache``.  A quotient filter, held as a
``repro_torch.filters`` ``(cfg, state)`` pair on the card (unless
``device="cpu"``), answers "might this prompt prefix be cached?" before
any remote KV-store lookup.  False positives cost one wasted remote
probe at rate ~2^-r; false negatives never happen.  Deletion support
(QF, not BF) matters here: evicted prefixes are removed from the filter.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import filters
from ..core import quotient_filter as qf
from ..core.fingerprint import fold_bytes


class PrefixCacheFilter:
    """Host-facing wrapper holding one functional filter ``(cfg, state)``.

    With ``auto_scale=True`` (default) the filter ingests through
    ``filters.auto_scale``: growth is incremental (an
    ``incremental_resize`` migration moves one ``chunk`` a request
    batch, membership exact throughout), and after heavy eviction the
    low watermark shrinks the table back, with hysteresis.  Each doubling
    takes a remainder bit, doubling the fp (wasted remote probe) rate, so
    provision ``r`` with the headroom you care about.

    ``family="steady_qf"`` swaps in the steady-state QF: every insert is
    O(buffer) with background settle ticks folding the buffer into the
    table.  ``family="cascade"`` backs the filter with the cascade (Q0
    in RAM, cold levels on flash); ``frozen_below=k`` demotes levels at
    depth >= k to the binary-fuse cold tier, and such caches cannot
    ``evict`` (``filters.UnsupportedOpError``; check ``can_evict``).
    """

    def __init__(self, q: int = 16, r: int = 14, seed: int = 0,
                 backend: str = "reference", auto_scale: bool = True,
                 chunk: int = 2048, family: str = "qf",
                 frozen_below: int | None = None, device=None, **family_spec):
        self.device = qf.resolve_device(device)
        if family in ("qf", "steady_qf"):
            if frozen_below is not None:
                raise ValueError("frozen_below needs family='cascade'")
            if family == "steady_qf":
                # O(buffer) insert per request batch, settle ticks of
                # ``chunk`` entries
                family_spec.setdefault("chunk", chunk)
            self.cfg, self.state = filters.make(
                family, device=self.device, q=q, r=r, seed=seed, backend=backend,
                **family_spec,
            )
        elif family == "cascade":
            family_spec.setdefault("ram_q", q)
            family_spec.setdefault("p", q + r)
            if frozen_below is not None:
                family_spec["frozen_below"] = frozen_below
            self.cfg, self.state = filters.make(
                "cascade", device=self.device, seed=seed, backend=backend,
                **family_spec,
            )
        else:
            raise ValueError(
                f"family must be 'qf', 'steady_qf' or 'cascade', got {family!r}"
            )
        self.auto_scale = auto_scale
        self.chunk = chunk

    @property
    def can_evict(self) -> bool:
        """False when the backing filter is frozen-tier (no deletes)."""
        return filters.supports(self.cfg, "delete")

    def _digest(self, prompts: np.ndarray) -> torch.Tensor:
        """Each prompt's 32-bit FNV-1a fold, as int32 bit patterns on the
        filter's device."""
        digests = np.asarray(
            [fold_bytes(np.asarray(p, np.int32).tobytes()) for p in prompts],
            np.uint32,
        )
        return torch.from_numpy(digests.view(np.int32)).to(self.device)

    def check_and_insert(self, prompts: np.ndarray) -> np.ndarray:
        """Membership for each prompt; then insert the misses."""
        keys = self._digest(prompts)
        hit = filters.contains(self.cfg, self.state, keys)
        # intra-batch duplicates: later copies are hits, on the device (a
        # stable sort keeps the first copy first, then adjacent-equal,
        # scattered back through the permutation)
        sk, order = torch.sort(keys, stable=True)
        dup_sorted = torch.zeros_like(hit)
        dup_sorted[1:] = sk[1:] == sk[:-1]
        dup = torch.zeros_like(hit)
        dup[order] = dup_sorted
        hit = hit | dup
        misses = keys[~hit]
        hit = hit.cpu().numpy()  # the caller's mask
        if misses.shape[0]:
            if self.auto_scale:
                self.cfg, self.state = filters.auto_scale(
                    self.cfg, self.state, misses, chunk=self.chunk
                )
            else:
                self.state = filters.insert(self.cfg, self.state, misses)
        return hit

    def evict(self, prompts: np.ndarray) -> None:
        keys = self._digest(prompts)
        # deletes are not defined mid-migration: collapse it first (the
        # host-level settle; eviction is already off the hot path)
        self.cfg, self.state = filters.settle(self.cfg, self.state)
        self.state = filters.delete(self.cfg, self.state, keys)
        if self.auto_scale and bool(filters.needs_shrink(self.cfg, self.state)):
            self.cfg, self.state = filters.shrink(self.cfg, self.state)

    @property
    def load(self) -> float:
        s = filters.stats(self.cfg, self.state)
        return float(s["load"] if "load" in s else s["q0_load"])
