"""Share of the traced point-read window in which no device operation
runs, %: ``device_idle_pct.probe``'s arithmetic, in the cells that move
``point_queries_per_s``."""

from amqbench.harness.metrics import reader

read = reader("device_idle_pct.probe")
