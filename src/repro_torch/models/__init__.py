"""The LLM skeleton's models (the port of ``repro.models``): every family's
forward, prefill and decode: GQA or MLA attention with a dense MLP or MoE,
the Mamba-2 SSM, the Griffin RG-LRU hybrid and the Whisper encoder-decoder."""

from . import attention, layers, model, moe, rglru, schema, ssm, transformer  # noqa
