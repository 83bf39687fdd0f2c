"""The benchmark of ``repro_torch``: its filters' ingest and lookup on one H100.

``python3 amqbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout, runs one cell of
``BENCHMARK.json`` and prints its result as the last line of its output.
"""
