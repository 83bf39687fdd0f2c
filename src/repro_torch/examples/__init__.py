"""The four examples of the repository, run against ``repro_torch``.

Each is a module with a ``main(argv=None)`` that prints what the JAX
package's example of the same name prints (``examples/*.py``) and returns
those numbers as a dict.  Each runs on the card unless given ``--device
cpu``::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.dedup_pipeline
    PYTHONPATH=src python -m repro_torch.examples.serve_prefix_cache
    PYTHONPATH=src python -m repro_torch.examples.train_e2e [--steps 200]

The keys, seeds and sizes are the JAX examples' own.
"""
