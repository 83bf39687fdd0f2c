"""Data pipeline with AMQ deduplication (the port of ``repro.data``)."""
