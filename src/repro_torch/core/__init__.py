"""The paper's AMQ data structures, bulk-parallel in PyTorch.

The port of ``repro.core``: the fingerprint hash, the quotient filter
(§3), the Bloom-filter baselines (§2: ``bloom`` and the SSD variants of
``bf_variants``), the cost model, and the canonical split of the frozen
tier (``fuse_filter``).  The ``BufferedQuotientFilter``/``CascadeFilter``
dataclasses (§4) are deprecated host-driven shims over the
``repro_torch.filters`` façade, exported as the JAX package exports
them.
"""

from . import bf_variants, bloom, cost_model, fingerprint, fuse_filter, quotient_filter
from .buffered_qf import BufferedQuotientFilter
from .cascade_filter import CascadeFilter

__all__ = [
    "bf_variants",
    "bloom",
    "cost_model",
    "fingerprint",
    "quotient_filter",
    "BufferedQuotientFilter",
    "CascadeFilter",
]
