"""The input-shape grid, and its inputs on the ``meta`` device.

The port of ``repro.launch.shapes``.  Every (arch x shape) cell runs
exactly one step function:

  train_4k    -> train_step   (loss + grads + optimizer update)
  prefill_32k -> prefill      (full-sequence forward + cache build)
  decode_32k  -> decode_step  (one new token against a seq_len KV cache)
  long_500k   -> decode_step  (sub-quadratic archs only)

``input_specs`` gives ``meta`` tensors where the reference gives
``ShapeDtypeStruct``s: shapes and dtypes, and no memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import model


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} ({cfg.family}) is full-attention — skipped per assignment"
        )
    return True, ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def spec_inputs(cfg, spec: ShapeSpec) -> dict:
    """``input_specs`` for a ``ShapeSpec`` that need not be in ``SHAPES``."""
    if spec.kind in ("train", "prefill"):
        batch = {"tokens": _meta((spec.batch, spec.seq), torch.int32)}
        if spec.kind == "train":
            batch["targets"] = _meta((spec.batch, spec.seq), torch.int32)
        if cfg.is_encoder_decoder:
            batch["frames"] = _meta((spec.batch, cfg.encoder_seq, cfg.d_model),
                                    getattr(torch, cfg.act_dtype))
        return {"batch": batch}
    # decode: one new token against a seq-long cache
    cache = model.init_cache(cfg, spec.batch, spec.seq, cfg.act_dtype, device="meta")
    return {"tokens": _meta((spec.batch, 1), torch.int32), "cache": cache}


def input_specs(cfg, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input (no allocation)."""
    return spec_inputs(cfg, SHAPES[shape_name])
