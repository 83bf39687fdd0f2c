"""The comparison that decides ``correct``: what every kind of cell shares.

Every number compared is a count of disagreements with the plain
reference, or of broken guarantees, and its limit is 0: the filters are
exact structures, so the program's structures, counts and answers equal
the reference's bit for bit or the run is wrong.  What a state is
compared by is its family's (``reference/<family>.py``, ``compare``:
for quotient filters ``plane_mismatches``, ``count_gap``,
``overflow_flags``); what a window's answers are compared by is its
kind's (``kinds/<kind>.py``).  Shared here:

- ``restore_digests``: states the window threw away at a restore whose
  digest differs from the reference's digest of that state.
"""

from __future__ import annotations

import torch

LIMIT = 0


def _words(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1)
    if flat.numel() and flat.numel() * flat.element_size() % 8 == 0:
        return flat.view(torch.uint8).view(torch.int64)
    return flat.to(torch.int64)


def digest(structures: list) -> torch.Tensor:
    """One int64 a field of every structure, fields in name order: the
    sum of its 8-byte words, word w weighted by 2w + 1 (mod 2**64).  A
    change of any one word changes it; computed on the device, read
    after the window."""
    out = []
    for s in structures:
        for k in sorted(s):
            w = _words(s[k])
            out.append((w * (2 * torch.arange(w.shape[0], device=w.device) + 1)).sum())
    return torch.stack(out)


def restore_mismatches(digests: list, ref: torch.Tensor) -> int:
    return sum(int(not torch.equal(d, ref)) for d in digests)


def verdict(numbers: dict) -> bool:
    return all(v <= LIMIT for v in numbers.values())
