"""The general parts of the benchmark: cells, the keys' generator, the
windows' clock, tracing and the check's shared numbers.  What belongs to
one configuration, traffic mix, traffic kind, family or metric sits in
files of its own, found by name: ``configs/``, ``traffic/``, ``kinds/``,
``reference/`` and ``metrics/``."""
