"""PyTorch and CUDA port of the paper's filters (see ``repro`` for the JAX original).

``repro_torch.filters`` is the entry point: the same ``make``/``insert``/
``contains``/``delete``/``merge``/``probe``/``stats`` verbs and spec
dictionaries as ``repro.filters``, with state on the CUDA device unless
a constructor is given ``device="cpu"``.
"""
