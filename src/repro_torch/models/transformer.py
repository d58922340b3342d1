"""Composable decoder stack: a loop over stacked periods.

The model is ``n_periods`` repetitions of a static *period* (list of
LayerSpec).  As in the JAX package, every parameter and cache leaf is
stacked on a leading ``(n_periods,)`` axis; a Python loop over the
periods takes the place of the reference's ``lax.scan``.

Each layer is pre-norm residual:  x += mixer(norm(x));  x += ffn(norm(x)).

Only attention mixers and dense SwiGLU FFNs are ported; the others raise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..core.batch_executor import resolve_device
from . import layers as L
from .config import ArchConfig, LayerSpec

Params = Dict[str, Any]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md, queue 1 item 4)"
    )


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer != "attention":
        raise _not_ported(f"the {spec.mixer!r} mixer")
    if spec.ffn != "dense":
        raise _not_ported(f"the {spec.ffn!r} ffn")


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
    _check_spec(spec)
    dev = generator.device
    p: Params = {
        "norm_mixer": L.rmsnorm_init(cfg, device=dev),
        "norm_ffn": L.rmsnorm_init(cfg, device=dev),
    }
    p["attn"] = L.attention_init(generator, cfg)
    p["ffn"] = L.swiglu_init(generator, cfg)
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
        _check_spec(spec)
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
    return cache


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _ffn(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
    return x + L.swiglu(p["ffn"], h)


def forward_train(
    stack: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, D) embedded inputs
    positions: torch.Tensor,  # (B, S)
) -> torch.Tensor:
    """Run the stacked periods over the embedded sequence."""
    for period in range(cfg.n_periods):
        params = _period(stack, period)
        for i, spec in enumerate(cfg.period):
            _check_spec(spec)
            p = params[f"layer{i}"]
            h = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
            mixed, _ = L.attention(p["attn"], cfg, h, positions)
            x = _ffn(p, cfg, x + mixed)
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
        cache_out: Params = {}
        for i, spec in enumerate(cfg.period):
            _check_spec(spec)
            p = params[f"layer{i}"]
            hn = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
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
            x = _ffn(p, cfg, x + mixed)
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
        for i, spec in enumerate(cfg.period):
            _check_spec(spec)
            p = params[f"layer{i}"]
            hn = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
            mixed, _ = L.attention(
                p["attn"], cfg, hn, positions,
                kv_cache=period_cache[f"layer{i}"], cache_index=cache_len,
            )
            x = _ffn(p, cfg, x + mixed)
    return x, cache
