"""Core transformer layers in PyTorch: RMSNorm, RoPE, GQA attention, SwiGLU.

The JAX package's ``models/layers.py`` function for function.  Parameters
are plain nested dicts of tensors; initialisers draw from an explicit
``torch.Generator`` and put their tensors on its device.  The casts sit
where the reference makes them: norms, RoPE and softmax in float32, then
back to the activation dtype; masked scores are ``-1e30``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding.constraints import constrain, constrain_split, model_axis_divides
from .config import ArchConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialisation helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, scale: Optional[float] = None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return x.mul_(float(scale)).to(dtype)


# ---------------------------------------------------------------------------
# Activations, in the op order of ``jax.nn``: on bfloat16 every op rounds to
# bfloat16 as XLA's does, so they match the reference bit for bit there.
# The MoE experts and the SSM mixers use them; the dense SwiGLU keeps the
# fused ``F.silu`` (one launch), which meets its tolerance without them
# ---------------------------------------------------------------------------


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp(x, 0)``."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(cfg: ArchConfig, width: Optional[int] = None, device=None) -> Params:
    return {"scale": torch.ones(width or cfg.d_model, dtype=cfg.pdtype(), device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * params["scale"].to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (Dh/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Grouped-query attention
# ---------------------------------------------------------------------------


def attention_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.pdtype()
    params = {
        "wq": dense_init(generator, (d, h, hd), dt),
        "wk": dense_init(generator, (d, kvh, hd), dt),
        "wv": dense_init(generator, (d, kvh, hd), dt),
        "wo": dense_init(generator, (h, hd, d), dt),
    }
    if cfg.qkv_bias:
        dev = generator.device
        params["bq"] = torch.zeros((h, hd), dtype=dt, device=dev)
        params["bk"] = torch.zeros((kvh, hd), dtype=dt, device=dev)
        params["bv"] = torch.zeros((kvh, hd), dtype=dt, device=dev)
    return params


def _project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as the GEMM that einsum runs
    (heads and head dim flattened), then the split into heads, which a
    sharded DTensor needs ready (``constrain_split``)."""
    d, h, k = w.shape
    y = torch.einsum("bsd,dn->bsn", x, w.reshape(d, h * k))
    return constrain_split(y, -1, h).unflatten(-1, (h, k))


def _qkv(params: Params, cfg: ArchConfig, x: torch.Tensor):
    q = _project_heads(x, params["wq"])
    k = _project_heads(x, params["wk"])
    v = _project_heads(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """q: (B, Sq, H, Dh), k: (B, Sk, KVH, Dh) -> (B, H, Sq, Sk)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = constrain_split(q, 2, kvh).reshape(b, sq, kvh, n_rep, hd)
    scores = torch.einsum("bsgrk,btgk->bgrst", qg, k)
    return scores.reshape(b, h, sq, k.shape[1])


def _gqa_values(probs: torch.Tensor, v: torch.Tensor, n_rep: int) -> torch.Tensor:
    """probs: (B, H, Sq, Sk), v: (B, Sk, KVH, Dh) -> (B, Sq, H, Dh)."""
    b, h, sq, sk = probs.shape
    kvh = v.shape[2]
    pg = constrain_split(probs, 1, kvh).reshape(b, kvh, n_rep, sq, sk)
    out = torch.einsum("bgrst,btgk->bsgrk", pg, v)
    return out.reshape(b, sq, h, v.shape[3])


def _scaled(scores: torch.Tensor, scale: float) -> torch.Tensor:
    """``scores * scale`` as the reference computes it: its scale is a NumPy
    float64 scalar, which JAX promotes with the scores to float32."""
    return scores.to(torch.float32) * float(scale)


# the reference scans query chunks at long sequence lengths (peak scores
# buffer (B, H, Cq, S)); the same thresholds keep the same arithmetic
CHUNKED_ATTN_THRESHOLD = 4096
Q_CHUNK = 256


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 quantization of K/V: (values (B,S,KVH,Dh), scales
    (B,S))."""
    x32 = x.to(torch.float32)
    scale = torch.amax(torch.abs(x32), dim=(-1, -2)) / 127.0 + 1e-8
    q = torch.clamp(torch.round(x32 / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def _chunk_size(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target."""
    cq = min(target, s)
    while s % cq:
        cq -= 1
    return cq


def _chunked_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_rep: int, scale: float, dtype
) -> torch.Tensor:
    """A loop over query chunks: peak scores buffer is (B, H, Cq, S)."""
    b, s, h, hd = q.shape
    cq = _chunk_size(s, Q_CHUNK)
    key_pos = torch.arange(s, device=q.device)
    chunks = []
    for i in range(s // cq):
        qc = q[:, i * cq : (i + 1) * cq]
        scores = _scaled(_gqa_scores(qc, k, n_rep), scale)  # (B, H, Cq, S)
        q_pos = i * cq + torch.arange(cq, device=q.device)
        mask = key_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask[None, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        chunks.append(_gqa_values(probs, v, n_rep))  # (B, Cq, H, Dh)
    return torch.cat(chunks, dim=1)


def attention(
    params: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Any]:
    """Full-sequence (train/prefill) or incremental (decode) attention.

    Decode: ``x`` is (B, 1, D), ``kv_cache`` is {"k", "v"[, "k_scale",
    "v_scale"]} with (B, S_max, KVH, Dh) layout (int8 + scales when the
    config selects a quantized cache), ``cache_index`` the current length.
    The cache is updated in place and returned.  As the reference's
    ``dynamic_update_slice`` does, the write position is clamped so the new
    rows fit, while the mask admits keys up to the unclamped index.
    """
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / np.sqrt(cfg.head_dim)
    q, k, v = _qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # pin Q/K/V layouts before any chunk loop (train/prefill full-sequence
    # paths only): heads on the model axis when they divide it (Megatron
    # head sharding), else K/V on the key-sequence dim, so that the scores
    # inherit the Sk sharding and softmax/value reductions become small
    # all-reduces.  A None dim means replicated, not unconstrained.
    if kv_cache is None:
        if model_axis_divides(cfg.n_heads):
            q = constrain(q, "batch", None, "model", None)
        if model_axis_divides(cfg.n_kv_heads):
            k = constrain(k, "batch", None, "model", None)
            v = constrain(v, "batch", None, "model", None)
        else:
            k = constrain(k, "batch", "model", None, None)
            v = constrain(v, "batch", "model", None, None)

    if kv_cache is not None:
        idx = int(cache_index)
        s_new = x.shape[1]
        s_max = kv_cache["k"].shape[1]
        start = min(max(idx, 0), s_max - s_new)
        rows = slice(start, start + s_new)
        if "k_scale" in kv_cache:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            kv_cache["k"][:, rows] = kq
            kv_cache["v"][:, rows] = vq
            kv_cache["k_scale"][:, rows] = ks
            kv_cache["v_scale"][:, rows] = vs
            k_full = kv_cache["k"].to(x.dtype) * kv_cache["k_scale"][..., None, None].to(x.dtype)
            v_full = kv_cache["v"].to(x.dtype) * kv_cache["v_scale"][..., None, None].to(x.dtype)
        else:
            kv_cache["k"][:, rows] = k.to(kv_cache["k"].dtype)
            kv_cache["v"][:, rows] = v.to(kv_cache["v"].dtype)
            k_full, v_full = kv_cache["k"], kv_cache["v"]
        new_cache = kv_cache
        scores = _scaled(_gqa_scores(q, k_full, n_rep), scale)  # (B, H, 1, S_max)
        key_pos = torch.arange(s_max, device=x.device)
        q_pos = idx + torch.arange(s_new, device=x.device)
        mask = key_pos[None, None, None, :] <= q_pos[None, None, :, None]
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = _gqa_values(probs, v_full, n_rep)
    else:
        if causal and x.shape[1] >= CHUNKED_ATTN_THRESHOLD:
            out = _chunked_causal_attention(q, k, v, n_rep, scale, x.dtype)
        else:
            scores = _scaled(_gqa_scores(q, k, n_rep), scale)  # (B, H, S, S)
            if causal:
                s = x.shape[1]
                mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
                scores = torch.where(mask[None, None], scores, -1e30)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = _gqa_values(probs, v, n_rep)
        new_cache = (k, v)  # prefill returns fresh K/V for cache seeding
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), new_cache


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------


def swiglu_init(generator: torch.Generator, cfg: ArchConfig, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.pdtype()
    return {
        "w_gate": dense_init(generator, (d, f), dt),
        "w_up": dense_init(generator, (d, f), dt),
        "w_down": dense_init(generator, (f, d), dt),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(torch.einsum("bsd,df->bsf", x, params["w_gate"]))
    up = torch.einsum("bsd,df->bsf", x, params["w_up"])
    return torch.einsum("bsf,fd->bsd", gate * up, params["w_down"])


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------


def embedding_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    dt = cfg.pdtype()
    vp = cfg.padded_vocab  # the reference pads the vocab to a multiple of 256
    params = {"tokens": dense_init(generator, (vp, cfg.d_model), dt, scale=1.0)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.d_model, vp), dt)
    return params


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tokens"][tokens.long()]


def unembed(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["tokens"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["head"])
    if cfg.padded_vocab != cfg.vocab_size:
        # mask padded vocab positions so softmax/argmax never select them
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits
