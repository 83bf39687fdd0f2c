"""Spans inside the port, recorded by a running ``torch.profiler`` session.

``span(name)`` marks one step of the port's insert and lookup paths.
While no profiler records, it returns one shared no-op context: a span
then costs a function call and one attribute read, and adds no aten
operation.  While ``torch.profiler.profile`` (or any profiler of
``torch.autograd.profiler``) records, it opens
``torch._C._profiler._RecordFunctionFast("repro_torch." + name)``, an
event on the profiler's own host clock, to which the CUDA activity's
timestamps are aligned.  A device operation belongs to the innermost
span open when its launch was issued: the CUDA runtime call that
launched it carries its correlation id and a host time.

There is no exporter and no registry of counts.  An operator gets the
spans in any ``torch.profiler`` session (``key_averages()``,
``export_chrome_trace``); a count is the number of a span's events, and
each kernel wrapper keeps its ``launches`` int.

The spans and their rule:

- ``filters.insert``, ``filters.contains``: the façade, entry to return;
- ``qf.fingerprint``, ``qf.sort``, ``qf.extract``, ``qf.build``: the
  bulk quotient-filter passes of an insert (keys to fingerprints, the
  sorts, the decode of a table, the rebuild);
- ``cascade.collapse.L<i>``: a cascade's merge of Q0..Q_i into level
  ``i``; ``cascade.merge_streams``: its streams gathered (each level's
  decode, nested, and requotient) and folded; ``cascade.combine``: the
  per-level answers or'ed;
- ``kernels.<wrapper>``: each CUDA wrapper on these paths
  (``fingerprint``, ``qf_probe``, ``cascade_probe``, ``qf_positions``,
  ``qf_build_planes``, ``qf_decode``), and ``kernels.unpack``, the fused cascade
  probe's per-level answers unpacked;
- ``host_read.<module>.<function>``: every deliberate host read on an
  insert or merge path (``analysis.trace_audit.KNOWN_SYNC_SITES``)
  encloses the ``int(...)``, ``bool(...)`` or ``.tolist()`` alone, so
  its span's host time is the host's wait for the card there.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``repro_torch.<name>`` while a profiler
    records, else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
