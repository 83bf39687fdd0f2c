"""The canonical fingerprint split of ``repro.core.fuse_filter``.

Only :func:`canonical_split` is ported so far: the unfrozen cascade
carries every cross-level stream in it.  The binary-fuse filter itself
belongs to the frozen-tier slice.
"""

from __future__ import annotations


def canonical_split(p: int) -> tuple[int, int]:
    """The (q, r) split every cross-level fingerprint stream is carried in.

    Any level's (q, r) split of the same p re-quotients to this one
    losslessly (``quotient_filter._requotient``).
    """
    if not (2 <= p <= 62):
        raise ValueError(f"fingerprint bits p must be in [2, 62], got {p}")
    r = min(32, p - 1)
    return p - r, r
