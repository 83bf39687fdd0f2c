"""The paper's AMQ data structures, bulk-parallel in PyTorch.

The port of ``repro.core``: the fingerprint hash, the quotient filter
(§3), the cost model, and the canonical split of the frozen tier.
"""

from . import cost_model, fingerprint, fuse_filter, quotient_filter

__all__ = ["cost_model", "fingerprint", "fuse_filter", "quotient_filter"]
