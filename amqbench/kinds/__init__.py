"""Traffic kinds, one module a kind, found by the mix's ``kind``.

A mix (``traffic/<mix>.json``) is parameters only; its kind is the code
that drives it, so that a mix of a known kind is added as a data file
and a new kind as a new module here.  ``amqbench.kinds.<kind>`` defines:

- ``OP``: what the window's calls do, as the metric readers see it
  (``"insert"``, ``"probe"``);
- ``PARAMS``: the parameters a mix of the kind gives besides the common
  ones (``harness/traffic.py``), and optionally ``validate(params)``;
- ``setup(engine, state, traffic, prefill) -> (state, plan)``: after
  the set-up fill, what the window needs (``plan``, a dict), every
  shape of the window run once;
- ``window(engine, state, traffic, plan, seconds, tracer)
  -> (state, record, outcome)``: the measured loop;
- ``expect(cell, engine, state, traffic, plan, outcome, trace)
  -> (numbers, failed, counters)``: once the window has closed, the
  numbers compared against the plain reference, the calls or states
  found wrong, and counters the per-layer readers may read.
"""

from __future__ import annotations

import importlib

from ..harness.traffic import validate as _common
from ..reference import model


def module(kind):
    """The module of a traffic kind."""
    if not isinstance(kind, str) or not kind.isidentifier():
        raise ValueError(f"a traffic kind is a module name, got {kind!r}")
    try:
        return importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no traffic kind {kind!r} (kinds/{kind}.py)") from e


def validate(params: dict) -> dict:
    """``params`` if they make a mix of their kind; else ValueError."""
    mod = module(params.get("kind"))
    _common(params, mod.PARAMS)
    if hasattr(mod, "validate"):
        mod.validate(params)
    return params


def reference(cell, traffic):
    """The configuration's reference after the set-up fill, and the
    set-up batches, regenerated from the seed."""
    m = model(cell.config)(cell.config["spec"], traffic.device)
    prefill = traffic.prefill_batches()
    for keys in prefill:
        m.insert(keys)
    return m, prefill
