"""Analytic FLOPs / bytes model per (arch x shape) -- the MODEL_FLOPS side
of the roofline's useful-compute ratio.

Per the assignment: MODEL_FLOPS = 6·N·D for training (N = params, D =
tokens; MoE uses N_active) and 2·N·D for inference shapes (no backward).
Attention's quadratic term is *excluded* from MODEL_FLOPS by that
definition -- it appears in the compiled HLO FLOPs instead, which is
exactly why the ratio is informative (ratio < 1 even for a perfect
implementation once S is large).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from .config import ArchConfig

SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def model_flops(cfg: ArchConfig, shape: str) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference)."""
    seq, batch, kind = SHAPES[shape]
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = seq * batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq * batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * batch


def attention_flops(cfg: ArchConfig, shape: str) -> float:
    """The quadratic attention matmuls (causal => x0.5), fwd (+2x bwd)."""
    seq, batch, kind = SHAPES[shape]
    n_attn_layers = (
        sum(1 for s in cfg.period if s.mixer == "attention") * cfg.n_periods
    )
    d_attn = cfg.n_heads * cfg.head_dim
    if kind == "decode":
        # scores + values against the full cache, one query token
        fwd = 2 * 2 * batch * seq * d_attn * n_attn_layers
        return float(fwd)
    fwd = 2 * 2 * batch * seq * seq * d_attn * n_attn_layers * 0.5
    return float(fwd * (3.0 if kind == "train" else 1.0))


def hbm_bytes_lower_bound(cfg: ArchConfig, shape: str) -> float:
    """Roofline memory floor: weights + (train) optimizer + decode cache
    traffic, per step, across the whole job."""
    seq, batch, kind = SHAPES[shape]
    n = cfg.param_count()
    p_bytes = 2.0  # bf16 weights
    if kind == "train":
        # fwd read + bwd read + grad write + optimizer read/write m,v
        opt_bytes = 2.0 if cfg.optimizer_state_dtype == "bfloat16" else 4.0
        return n * (3 * p_bytes + 4 * opt_bytes)
    if kind == "prefill":
        return n * p_bytes
    # decode: weights (active) + KV/state cache read per token
    n_attn_layers = (
        sum(1 for s in cfg.period if s.mixer == "attention") * cfg.n_periods
    )
    kv = 2 * batch * seq * cfg.n_kv_heads * cfg.head_dim * 2.0 * n_attn_layers
    return cfg.active_param_count() * p_bytes + kv
