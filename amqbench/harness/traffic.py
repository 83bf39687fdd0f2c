"""Keys made on the device from a seed, and what every traffic mix gives.

A traffic mix is a JSON file of parameters (``traffic/<mix>.json``),
read by the code of its kind (``kinds/<kind>.py``).  Every mix gives:

- ``kind``: the name of that code, found by name;
- ``prefill_keys``, ``prefill_batch_keys``: keys inserted in set-up
  through the same insert calls, in batches of that size;
- ``batch_keys``: keys in one call of the window;
- ``in_flight``: calls issued and not yet complete, at most;

its kind's own parameters (the kind's ``PARAMS``), and as text read by
no code its ``why`` and what it ``assumed``.

Every key is a uniform 32-bit pattern (int32) from a generator on the
device seeded by the run's seed and the batch's place (a tag of the
kind's and an index), so one seed gives the same batches in every run
and to the reference.
"""

from __future__ import annotations

import torch

COMMON = ("kind", "prefill_keys", "prefill_batch_keys", "batch_keys", "in_flight")
PREFILL, WINDOW, POOL = 1, 2, 3  # tags of the batches' places
_M64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for ``seed`` and the batch's place."""
    h = splitmix64(seed & _M64)
    for t in tags:
        h = splitmix64(h ^ t)
    return h >> 1


def generator(device, seed: int, *tags: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *tags))
    return g


def uniform_keys(n: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.randint(-(2**31), 2**31, (n,), generator=g, device=device,
                         dtype=torch.int32)


def validate(params: dict, own: tuple) -> None:
    """Refuse a mix that lacks a common parameter or one of its kind's
    (``own``), or whose set-up fill is not whole batches."""
    missing = [k for k in COMMON + tuple(own) if k not in params]
    if missing:
        raise ValueError(f"traffic parameters missing: {missing}")
    n, b = params["prefill_keys"], params["prefill_batch_keys"]
    if n and (b < 1 or n % b):
        raise ValueError("prefill_keys must be a whole number of prefill batches")
    if params["in_flight"] < 1:
        raise ValueError("in_flight must be at least 1")


class Traffic:
    """One mix's parameters for one seed on one device."""

    def __init__(self, params: dict, seed: int, device):
        self.__dict__.update(params)
        self.seed = seed
        self.device = torch.device(device)

    def prefill_batches(self) -> list:
        """The set-up batches, in insert order."""
        n, b = self.prefill_keys, self.prefill_batch_keys
        return [self.prefill_batch(j) for j in range(n // b if n else 0)]

    def prefill_batch(self, j: int) -> torch.Tensor:
        g = generator(self.device, self.seed, PREFILL, j)
        return uniform_keys(self.prefill_batch_keys, g, self.device)
