"""Composable decoder stack: a loop over stacked periods.

The model is ``n_periods`` repetitions of a static *period* (list of
LayerSpec).  As in the JAX package, every parameter and cache leaf is
stacked on a leading ``(n_periods,)`` axis; a Python loop over the
periods takes the place of the reference's ``lax.scan``.

Each layer is pre-norm residual:  x += mixer(norm(x));  x += ffn(norm(x)).
The mixer is attention, Mamba or RWKV-6; the FFN a dense SwiGLU, the MoE or
RWKV's channel mix (``ffn="none"``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.batch_executor import resolve_device
from ..sharding.constraints import constrain_bsd
from . import layers as L
from . import moe as M
from . import ssm as S
from .config import ArchConfig, LayerSpec

Params = Dict[str, Any]


def _period(tree: Params, p: int) -> Params:
    """Period ``p`` of a stacked tree (views, so writes reach the stack)."""
    return {k: _period(v, p) if isinstance(v, dict) else v[p] for k, v in tree.items()}


def _stack(periods: List[Params]) -> Params:
    first = periods[0]
    return {
        k: _stack([t[k] for t in periods]) if isinstance(v, dict)
        else torch.stack([t[k] for t in periods])
        for k, v in first.items()
    }


# ---------------------------------------------------------------------------
# Period init
# ---------------------------------------------------------------------------


def _layer_init(generator: torch.Generator, cfg: ArchConfig, spec: LayerSpec) -> Params:
    dev = generator.device
    p: Params = {
        "norm_mixer": L.rmsnorm_init(cfg, device=dev),
        "norm_ffn": L.rmsnorm_init(cfg, device=dev),
    }
    if spec.mixer == "attention":
        p["attn"] = L.attention_init(generator, cfg)
    elif spec.mixer == "mamba":
        p["mamba"] = S.mamba_init(generator, cfg)
    elif spec.mixer == "rwkv6":
        p["rwkv"] = S.rwkv6_init(generator, cfg)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn == "dense":
        p["ffn"] = L.swiglu_init(generator, cfg)
    elif spec.ffn == "moe":
        p["moe"] = M.moe_init(generator, cfg)
    elif spec.ffn == "none":
        p["cmix"] = S.rwkv_channel_mix_init(generator, cfg)
    else:
        raise ValueError(spec.ffn)
    return p


def _empty_like_stacked(tree: Params, n: int) -> Params:
    return {
        k: _empty_like_stacked(v, n) if isinstance(v, dict)
        else v.new_empty((n,) + tuple(v.shape))
        for k, v in tree.items()
    }


def _fill(dst: Params, src: Params, p: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _fill(dst[k], v, p)
        else:
            dst[k][p] = v


def init_stack(generator: torch.Generator, cfg: ArchConfig) -> Params:
    """Stacked parameters: each leaf gains a leading (n_periods,) axis.

    Drawn one period at a time into the stacked leaves, so the peak is the
    stack plus one period."""
    stack: Params = {}
    for p in range(cfg.n_periods):
        period = {
            f"layer{i}": _layer_init(generator, cfg, spec) for i, spec in enumerate(cfg.period)
        }
        if p == 0:
            stack = _empty_like_stacked(period, cfg.n_periods)
        _fill(stack, period, p)
    return stack


# ---------------------------------------------------------------------------
# Cache structure (decode)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> Params:
    """Per-period-position caches stacked on a leading (n_periods,) axis."""
    dev = resolve_device(device)
    n = cfg.n_periods
    cache: Params = {}
    for i, spec in enumerate(cfg.period):
        if spec.mixer == "attention":
            kvh, hd = cfg.n_kv_heads, cfg.head_dim
            if cfg.kv_cache_dtype == "int8":
                cache[f"layer{i}"] = {
                    "k": torch.zeros((n, batch, max_len, kvh, hd), dtype=torch.int8, device=dev),
                    "v": torch.zeros((n, batch, max_len, kvh, hd), dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros((n, batch, max_len), dtype=torch.float32, device=dev),
                    "v_scale": torch.zeros((n, batch, max_len), dtype=torch.float32, device=dev),
                }
            else:
                cache[f"layer{i}"] = {
                    "k": torch.zeros((n, batch, max_len, kvh, hd), dtype=cfg.dtype(), device=dev),
                    "v": torch.zeros((n, batch, max_len, kvh, hd), dtype=cfg.dtype(), device=dev),
                }
        elif spec.mixer == "mamba":
            cache[f"layer{i}"] = _stack([S.mamba_state_init(cfg, batch, dev)] * n)
        elif spec.mixer == "rwkv6":
            cache[f"layer{i}"] = _stack([S.rwkv6_state_init(cfg, batch, dev)] * n)
    return cache


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _ffn(p: Params, cfg: ArchConfig, spec: LayerSpec, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
    if spec.ffn == "dense":
        return x + L.swiglu(p["ffn"], h)
    if spec.ffn == "moe":
        return x + M.moe_apply(p["moe"], cfg, h)
    return x + S.rwkv_channel_mix(p["cmix"], h)


def _period_train(
    params: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    # seq-sharded carry = Megatron sequence parallelism: the saved
    # residual stack shrinks by the model-axis size
    x = constrain_bsd(x, seq_shard=True)
    for i, spec in enumerate(cfg.period):
        p = params[f"layer{i}"]
        h = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
        if spec.mixer == "attention":
            mixed, _ = L.attention(p["attn"], cfg, h, positions)
        elif spec.mixer == "mamba":
            mixed, _ = S.mamba_forward(p["mamba"], cfg, h)
        else:
            mixed, _ = S.rwkv6_forward(p["rwkv"], cfg, h)
        x = _ffn(p, cfg, spec, x + mixed)
    return constrain_bsd(x, seq_shard=True)


def forward_train(
    stack: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, D) embedded inputs
    positions: torch.Tensor,  # (B, S)
    remat: bool = True,
) -> torch.Tensor:
    """Run the stacked periods over the embedded sequence.

    ``remat`` keeps only each period's input for the backward pass and
    recomputes the period there, as the reference's period-level
    ``jax.checkpoint`` does.
    """
    for period in range(cfg.n_periods):
        params = _period(stack, period)
        if remat:
            x = checkpoint(_period_train, params, cfg, x, positions, use_reentrant=False)
        else:
            x = _period_train(params, cfg, x, positions)
    return x


def forward_prefill(
    stack: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    max_len: int,
) -> Tuple[torch.Tensor, Params]:
    """Forward pass that also builds the decode cache."""
    s = x.shape[1]
    pad = max_len - s
    if pad < 0:
        raise ValueError(f"prompt of {s} positions is longer than max_len {max_len}")
    caches: List[Params] = []
    for period in range(cfg.n_periods):
        params = _period(stack, period)
        x = constrain_bsd(x, seq_shard=True)
        cache_out: Params = {}
        for i, spec in enumerate(cfg.period):
            p = params[f"layer{i}"]
            hn = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
            if spec.mixer == "attention":
                mixed, (k, v) = L.attention(p["attn"], cfg, hn, positions)
                seq = (0, 0, 0, 0, 0, pad)  # zero rows after the prompt, on axis 1
                if cfg.kv_cache_dtype == "int8":
                    kq, ks = L.quantize_kv(k)
                    vq, vs = L.quantize_kv(v)
                    cache_out[f"layer{i}"] = {
                        "k": F.pad(kq, seq),
                        "v": F.pad(vq, seq),
                        "k_scale": F.pad(ks, (0, pad)),
                        "v_scale": F.pad(vs, (0, pad)),
                    }
                else:
                    cache_out[f"layer{i}"] = {"k": F.pad(k, seq), "v": F.pad(v, seq)}
            elif spec.mixer == "mamba":
                mixed, state = S.mamba_forward(p["mamba"], cfg, hn)
                kc = cfg.ssm_conv - 1
                conv = state["conv"]
                if conv.shape[1] < kc:  # a prompt shorter than the conv tail
                    conv = F.pad(conv, (0, 0, kc - conv.shape[1], 0))
                cache_out[f"layer{i}"] = {"h": state["h"], "conv": conv}
            else:
                mixed, state = S.rwkv6_forward(p["rwkv"], cfg, hn)
                cache_out[f"layer{i}"] = state
            x = _ffn(p, cfg, spec, x + mixed)
        caches.append(cache_out)
    return x, _stack(caches)


def forward_decode(
    stack: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache: Params,
    cache_len: int,  # current context length
) -> Tuple[torch.Tensor, Params]:
    """Single-token decode step against the cache, which is updated in place."""
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.int32, device=x.device)
    for period in range(cfg.n_periods):
        params = _period(stack, period)
        period_cache = _period(cache, period)
        x = constrain_bsd(x)
        for i, spec in enumerate(cfg.period):
            p = params[f"layer{i}"]
            c = period_cache[f"layer{i}"]
            hn = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
            if spec.mixer == "attention":
                mixed, _ = L.attention(
                    p["attn"], cfg, hn, positions, kv_cache=c, cache_index=cache_len,
                )
            else:
                if spec.mixer == "mamba":
                    mixed, state = S.mamba_decode_step(p["mamba"], cfg, hn, c)
                else:
                    mixed, state = S.rwkv6_decode_step(p["rwkv"], cfg, hn, c)
                for name, value in state.items():  # the recurrent state, in place
                    c[name].copy_(value)
            x = _ffn(p, cfg, spec, x + mixed)
    return x, cache
