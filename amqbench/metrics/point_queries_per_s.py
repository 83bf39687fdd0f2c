"""Point reads answered in the window over the window's seconds (host
clock): the rate of one reader whose small probe calls each return
before the next is issued.  The arithmetic is ``probe_queries_per_s``'s;
the metric stands apart so that a host-bound cell has a bound of its own."""

from amqbench.harness.metrics import reader

read = reader("probe_queries_per_s")
