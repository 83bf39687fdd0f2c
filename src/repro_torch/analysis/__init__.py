"""Static analysis for the port: host-sync and kernel-contract checks.

The port of ``repro.analysis``.  Three cooperating analyzers, runnable as
``python -m repro_torch.analysis`` (see ``__main__``):

- :mod:`repro_torch.analysis.lint` — an AST rule engine that flags host
  reads (``.item()``, casts, ``.cpu()``, branches on tensors) inside
  device-reachable code (rules in :mod:`repro_torch.analysis.rules`),
  with a committed per-file allowlist ``baseline.toml``.
- :mod:`repro_torch.analysis.trace_audit` — runs every registry family's
  ops under a ``TorchDispatchMode``, records each op's aten operations
  and whether it read the host, and diffs both against the committed
  ``trace_manifest.json`` (a ``cpu`` and a ``cuda`` section).
- :mod:`repro_torch.analysis.spec_check` — statically checks each CUDA
  kernel's contract: every ``extern "C"`` entry of ``csrc/*.cu`` has a
  ctypes binding of its prototype's widths, and each kernel wrapper a
  ``launches`` counter, a plain version, a test case and a
  ``chip_smoke.py`` entry.
"""
