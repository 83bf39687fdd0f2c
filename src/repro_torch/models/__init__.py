"""The LLM skeleton's models (the port of ``repro.models``): the decoder
families' forward, prefill and decode, GQA or MLA attention with a dense
MLP or MoE."""

from . import attention, layers, model, moe, schema, transformer  # noqa
