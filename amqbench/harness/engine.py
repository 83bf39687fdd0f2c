"""What the window drives: the program's façade, or the control in its place.

``Port`` is the system under test: ``repro_torch.filters`` ``make``,
``insert`` and ``contains`` for the configuration's family and spec.
Its outputs are read back by the family's reference module
(``read_state``).  ``Control`` is the plain reference of the family put
in the program's place one fingerprint bit short of the configuration's
precision, for the check that a wrong answer reads as not correct.
"""

from __future__ import annotations

import torch

from ..reference import family


def leaves(state):
    """Every tensor of a state of the program, in field order."""
    if isinstance(state, torch.Tensor):
        yield state
    else:
        for part in state:
            yield from leaves(part)


class Port:
    """The program: ``repro_torch.filters`` at the configuration's spec."""

    def __init__(self, config: dict, device):
        from repro_torch import filters

        self.filters = filters
        self.family = config["family"]
        self.reference = family(config)
        self.spec = config["spec"]
        self.device = torch.device(device)
        self.cfg = None

    def make(self):
        self.cfg, state = self.filters.make(self.family, device=self.device, **self.spec)
        return state

    def insert(self, state, keys):
        return self.filters.insert(self.cfg, state, keys)

    def contains(self, state, keys):
        return self.filters.contains(self.cfg, state, keys)

    def structures(self, state) -> list:
        return self.reference.read_state(state)

    def snapshot(self, state):
        return [t.clone() for t in leaves(state)]

    def restore(self, state, snap):
        """The state put back to ``snap``, or emptied without one, in place."""
        for i, t in enumerate(leaves(state)):
            if snap is None:
                t.zero_()
            else:
                t.copy_(snap[i])
        return state


class Control:
    """The family's plain reference in the program's place, at ``drop``
    fingerprint bits fewer than the configuration states."""

    def __init__(self, config: dict, device, drop: int = 1):
        self.model = family(config).Model
        self.spec = config["spec"]
        self.device = torch.device(device)
        self.drop = drop

    def make(self):
        return self.model(self.spec, self.device, self.drop)

    def insert(self, state, keys):
        state.insert(keys)
        return state

    def contains(self, state, keys):
        return state.contains(keys)

    def structures(self, state) -> list:
        return state.structures()

    def snapshot(self, state):
        return state.copy()

    def restore(self, state, snap):
        return self.make() if snap is None else snap.copy()
