"""The paper's AMQ data structures, bulk-parallel in PyTorch.

The port of ``repro.core``: the fingerprint hash, the quotient filter
(§3), the Bloom-filter baselines (§2: ``bloom`` and the SSD variants of
``bf_variants``), the cost model, and the canonical split of the frozen
tier.
"""

from . import bf_variants, bloom, cost_model, fingerprint, fuse_filter, quotient_filter

__all__ = [
    "bf_variants",
    "bloom",
    "cost_model",
    "fingerprint",
    "fuse_filter",
    "quotient_filter",
]
