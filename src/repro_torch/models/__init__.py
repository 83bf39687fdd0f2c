"""The LLM skeleton's models (the port of ``repro.models``): the GQA decoder
families' forward, prefill and decode."""

from . import attention, layers, model, schema, transformer  # noqa
