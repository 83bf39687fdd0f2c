"""Plain references of the filter families, one module a family.

``amqbench.reference.<name>`` is found by the configuration's
``reference`` key, or else by its ``family`` (the program's registry
name), so that a family, or a variant of one, is added as a new module.
Each module defines:

- ``Model(spec, device, drop=0)``: the family's structures worked out
  from the keys it was given, in plain PyTorch, with ``insert``,
  ``contains`` (exact fingerprint membership), ``structures`` (each
  structure as a dict of tensors), ``copy``, ``capacity`` (keys it is
  built to hold) and ``visits`` (structures each probe must read);
  ``drop`` lowers the precision by that many fingerprint bits;
- ``read_state(state)``: a state of the program as the same dicts;
- ``compare(port, ref)``: the numbers compared between them, each a
  count of disagreements.

Nothing here imports the program under test.
"""

import importlib


def family(config: dict):
    """The reference module of a configuration."""
    return importlib.import_module(f"{__name__}.{config.get('reference', config['family'])}")


def model(config: dict):
    """The reference ``Model`` class of a configuration."""
    return family(config).Model
