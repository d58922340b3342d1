"""Input stand-ins for every (architecture x input-shape) cell.

``input_specs`` returns allocation-free stand-ins (``meta`` tensors of the
right shape and dtype) for every model input of a given shape cell, where
the JAX package returns ``ShapeDtypeStruct``s.  The modality frontends of
the [audio]/[vlm] architectures are stubs: ``prefix`` is the precomputed
frame/patch embedding tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.config import ArchConfig
from ..models.model import Model

# The assigned shape grid (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


@dataclass(frozen=True)
class Cell:
    arch: str
    shape: str

    @property
    def seq_len(self) -> int:
        return SHAPES[self.shape][0]

    @property
    def batch(self) -> int:
        return SHAPES[self.shape][1]

    @property
    def kind(self) -> str:
        return SHAPES[self.shape][2]


def cell_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic mixing (DESIGN.md §4)."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md §4)"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str) -> Dict[str, Any]:
    """``meta`` stand-ins for the step function of this cell."""
    from ..train.train_step import _abstract_cache

    seq, batch, kind = SHAPES[shape]
    i32 = torch.int32
    if kind == "train":
        specs: Dict[str, Any] = {
            "tokens": _meta((batch, seq), i32),
            "labels": _meta((batch, seq), i32),
        }
        if cfg.prefix_len:
            specs["prefix"] = _meta((batch, cfg.prefix_len, cfg.d_model), cfg.dtype())
        return specs
    if kind == "prefill":
        specs = {"tokens": _meta((batch, seq), i32)}
        if cfg.prefix_len:
            specs["prefix"] = _meta((batch, cfg.prefix_len, cfg.d_model), cfg.dtype())
        return specs
    # decode: one new token against a seq-length cache
    model = Model(cfg)
    cache = _abstract_cache(model, batch, seq)
    return {
        "token": _meta((batch, 1), i32),
        "cache": cache,
        "cache_len": _meta((), i32),
    }


def abstract_params(cfg: ArchConfig):
    from ..train.train_step import _abstract_params

    return _abstract_params(Model(cfg))
