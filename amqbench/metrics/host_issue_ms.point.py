"""Mean host milliseconds from a point read's ``contains`` call's entry
to its return: ``host_issue_ms.probe``'s arithmetic, in the cells that
move ``point_queries_per_s``."""

from amqbench.harness.metrics import reader

read = reader("host_issue_ms.probe")
