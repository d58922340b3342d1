"""State-space and linear-attention mixers in PyTorch: Mamba (Jamba) and
RWKV-6 (Finch).

The JAX package's ``models/ssm.py`` function for function.  Both run in
chunked form: a Python loop over sequence chunks carries the recurrent
state (the reference's ``lax.scan``), while work *within* a chunk is
parallel: a doubling scan for Mamba (the reference's associative scan,
same combine), decay-cumprod linear attention for RWKV-6.  The chunk asserts
are the reference's: a sequence longer than one chunk must be a multiple of
it.

Decode performs the exact recurrence, one step per token, O(1) in context
length.

Left out, as a training concern: the reference's ``jax.checkpoint`` of the
chunk bodies.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding.constraints import constrain
from .config import ArchConfig
from .layers import dense_init, sigmoid, silu, softplus

Params = Dict[str, Any]

MAMBA_CHUNK = 256
RWKV_CHUNK = 64


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Each position's previous token along axis 1, zeros before the first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------


def mamba_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    d, di, n, kconv = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dt_rank = max(1, d // 16)
    dt = cfg.pdtype()
    dev = generator.device
    return {
        "in_proj": dense_init(generator, (d, 2 * di), dt),
        "conv_w": dense_init(generator, (kconv, di), dt, scale=1.0 / np.sqrt(kconv)),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": dense_init(generator, (di, dt_rank + 2 * n), dt),
        "dt_proj": dense_init(generator, (dt_rank, di), dt),
        "dt_bias": torch.zeros((di,), dtype=dt, device=dev),
        "A_log": torch.log(
            torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(di, n)
        ).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, (di, d), dt),
    }


def _mamba_discretize(params, cfg: ArchConfig, xz: torch.Tensor):
    """Project a chunk to (dA, dBx, C, z, gate-path x) tensors."""
    n = cfg.ssm_state
    dt_rank = max(1, cfg.d_model // 16)
    x, z = torch.chunk(xz, 2, dim=-1)  # (B, C, Di) each
    proj = torch.einsum("bci,ir->bcr", x, params["x_proj"])
    dt_r, b_mat, c_mat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt_full = softplus(
        torch.einsum("bcr,ri->bci", dt_r, params["dt_proj"]) + params["dt_bias"]
    ).to(torch.float32)
    a = -torch.exp(params["A_log"])  # (Di, N)
    dA = torch.exp(dt_full[..., None] * a)  # (B, C, Di, N)
    dBx = (
        dt_full[..., None]
        * b_mat[:, :, None, :].to(torch.float32)
        * x[..., None].to(torch.float32)
    )  # (B, C, Di, N)
    return x, z, dA, dBx, c_mat


def _mamba_chunk_scan(h0: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor):
    """Parallel in-chunk scan: h_t = dA_t * h_{t-1} + dBx_t, given h0.

    A doubling (Hillis-Steele) scan with the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``: log2(C) steps, each
    combining every position with the one ``offset`` before it."""
    a_acc, b_acc = dA, dBx
    c = dA.shape[1]
    offset = 1
    while offset < c:
        a_prev, b_prev = a_acc[:, :-offset], b_acc[:, :-offset]
        a_cur, b_cur = a_acc[:, offset:], b_acc[:, offset:]
        a_acc = torch.cat([a_acc[:, :offset], a_prev * a_cur], dim=1)
        b_acc = torch.cat([b_acc[:, :offset], a_cur * b_prev + b_cur], dim=1)
        offset *= 2
    h = a_acc * h0[:, None] + b_acc  # (B, C, Di, N)
    return h, h[:, -1]


def mamba_forward(
    params: Params,
    cfg: ArchConfig,
    u: torch.Tensor,  # (B, S, D)
    chunk: int = MAMBA_CHUNK,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba; returns output and final recurrent state."""
    b, s, d = u.shape
    di, n, kconv = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    xz_all = torch.einsum("bsd,de->bse", u, params["in_proj"])  # (B, S, 2Di)
    # pin the inner (channel) dim on the model axis: the whole selective
    # scan is channel-independent, so Di shards cleanly (tensor parallel)
    xz_all = constrain(xz_all, "batch", None, "model")

    x_all = xz_all[..., :di]
    # causal depthwise conv over the whole sequence
    x_pad = F.pad(x_all, (0, 0, kconv - 1, 0))
    conv = sum(
        x_pad[:, i : i + s] * params["conv_w"][i][None, None, :] for i in range(kconv)
    ) + params["conv_b"]
    x_conv = silu(conv)
    xz_all = torch.cat([x_conv, xz_all[..., di:]], dim=-1)

    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    h = constrain(torch.zeros((b, di, n), dtype=torch.float32, device=u.device),
                  "batch", "model", None)
    ys = []
    for c0 in range(0, s, chunk):
        xz = constrain(xz_all[:, c0 : c0 + chunk], "batch", None, "model")
        x, z, dA, dBx, c_mat = _mamba_discretize(params, cfg, xz)
        dA = constrain(dA, "batch", None, "model", None)
        dBx = constrain(dBx, "batch", None, "model", None)
        h_all, h = _mamba_chunk_scan(h, dA, dBx)
        y = torch.einsum("bcin,bcn->bci", h_all, c_mat.to(torch.float32))
        y = y + params["D"] * x.to(torch.float32)
        ys.append((y * silu(z.to(torch.float32))).to(u.dtype))
        h = constrain(h, "batch", "model", None)
    y = torch.cat(ys, dim=1)
    out = torch.einsum("bsi,id->bsd", y, params["out_proj"])
    state = {
        "h": h,
        "conv": x_all[:, s - (kconv - 1) :, :] if s >= kconv - 1 else x_all,
    }
    return out, state


def mamba_decode_step(
    params: Params, cfg: ArchConfig, u: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token Mamba step.  u: (B, 1, D); state: {h (B,Di,N), conv (B,k-1,Di)}."""
    di = cfg.d_inner
    xz = torch.einsum("bsd,de->bse", u, params["in_proj"])  # (B, 1, 2Di)
    x_new = xz[..., :di]  # (B, 1, Di)
    window = torch.cat([state["conv"], x_new], dim=1)  # (B, k, Di)
    conv = (
        torch.einsum("bki,ki->bi", window, params["conv_w"]) + params["conv_b"]
    )[:, None, :]
    x_conv = silu(conv)
    xz = torch.cat([x_conv, xz[..., di:]], dim=-1)
    x, z, dA, dBx, c_mat = _mamba_discretize(params, cfg, xz)
    h = dA[:, 0] * state["h"] + dBx[:, 0]  # (B, Di, N)
    y = torch.einsum("bin,bn->bi", h, c_mat[:, 0].to(torch.float32))
    y = y + params["D"] * x[:, 0].to(torch.float32)
    y = (y * silu(z[:, 0].to(torch.float32))).to(u.dtype)
    out = torch.einsum("bi,id->bd", y, params["out_proj"])[:, None, :]
    return out, {"h": h, "conv": window[:, 1:]}


def mamba_state_init(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=cfg.dtype(),
                            device=device),
    }


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay linear attention
# ---------------------------------------------------------------------------


def rwkv6_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    d = cfg.d_model
    n_heads = max(1, d // 64)
    dt = cfg.pdtype()
    dev = generator.device
    return {
        "w_r": dense_init(generator, (d, d), dt),
        "w_k": dense_init(generator, (d, d), dt),
        "w_v": dense_init(generator, (d, d), dt),
        "w_g": dense_init(generator, (d, d), dt),
        "w_decay": dense_init(generator, (d, d), dt, scale=0.01),
        "decay_bias": torch.full((d,), -6.0, dtype=torch.float32, device=dev),  # slow decay
        "bonus": torch.zeros((n_heads, 64), dtype=torch.float32, device=dev),  # 'u' boost
        "w_o": dense_init(generator, (d, d), dt),
        "shift_mix": torch.full((d,), 0.5, dtype=dt, device=dev),  # token-shift mix
    }


def _rwkv_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads)


def _rwkv_chunk(state, rr, kk, vv, ww, u):
    """One chunk of RWKV-6 in float32: (new state, (B, C, H, hd) output)."""
    # cumulative decay within the chunk: P_t = prod_{j<=t} w_j
    logw = torch.log(torch.clamp(ww, min=1e-12))
    cum = torch.cumsum(logw, dim=1)  # (B, C, H, hd)
    p_incl = torch.exp(cum)
    p_excl = torch.exp(cum - logw)  # prod_{j<t}
    # inter-chunk: r_t . (P_excl_t * state)
    inter = torch.einsum("bchk,bhkl->bchl", rr * p_excl, state)
    # intra-chunk: sum_{j<t} (r_t P_excl_t / P_incl_j) (k_j . ) v_j + bonus diag
    r_hat = rr * p_excl
    k_hat = kk / torch.clamp(p_incl, min=1e-12)
    att = torch.einsum("bchk,bjhk->bhcj", r_hat, k_hat)  # (B, H, C, C)
    c_len = att.shape[-1]
    mask = torch.tril(torch.ones((c_len, c_len), dtype=torch.bool, device=att.device), -1)
    att = torch.where(mask[None, None], att, 0.0)
    intra = torch.einsum("bhcj,bjhl->bchl", att, vv)
    # current-token bonus path: (r_t . (u * k_t)) v_t
    bonus = torch.einsum("bchk,bchk->bch", rr, u[None, None] * kk)
    cur = bonus[..., None] * vv
    out = inter + intra + cur  # (B, C, H, hd)
    # state update: S' = diag(P_incl_T) S + sum_j (P_incl_T/P_incl_j) k_j v_j
    p_total = p_incl[:, -1]  # (B, H, hd)
    scale = p_total[:, None] / torch.clamp(p_incl, min=1e-12)  # (B, C, H, hd)
    outer = torch.einsum("bchk,bchl->bhkl", kk * scale, vv)
    return p_total[..., None] * state + outer, out


def rwkv6_forward(
    params: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, D)
    chunk: int = RWKV_CHUNK,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s, d = x.shape
    n_heads = max(1, d // 64)
    hd = d // n_heads

    # token shift: mix current with previous token
    xm = x + params["shift_mix"] * (_shift(x) - x)

    r = _rwkv_heads(torch.einsum("bsd,de->bse", xm, params["w_r"]), n_heads)
    k = _rwkv_heads(torch.einsum("bsd,de->bse", xm, params["w_k"]), n_heads)
    v = _rwkv_heads(torch.einsum("bsd,de->bse", xm, params["w_v"]), n_heads)
    g = silu(torch.einsum("bsd,de->bse", xm, params["w_g"]))
    # data-dependent per-channel decay in (0, 1)
    w = torch.exp(
        -torch.exp(
            torch.einsum("bsd,de->bse", xm, params["w_decay"]).to(torch.float32)
            + params["decay_bias"]
        )
    )
    w = _rwkv_heads(w, n_heads)  # (B, S, H, hd)

    chunk = min(chunk, s)
    assert s % chunk == 0
    u = params["bonus"]  # (H, hd)
    state = torch.zeros((b, n_heads, hd, hd), dtype=torch.float32, device=x.device)
    outs = []
    for c0 in range(0, s, chunk):
        rr, kk, vv, ww = (t[:, c0 : c0 + chunk].to(torch.float32) for t in (r, k, v, w))
        state, out = _rwkv_chunk(state, rr, kk, vv, ww, u)
        outs.append(out)
    out = torch.cat(outs, dim=1).reshape(b, s, d).to(x.dtype)
    out = out * g
    out = torch.einsum("bsd,de->bse", out, params["w_o"])
    return out, {"state": state, "x_last": x[:, -1]}


def rwkv6_decode_step(
    params: Params, cfg: ArchConfig, x: torch.Tensor, cache: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token RWKV step; O(1) in context length."""
    b, _, d = x.shape
    n_heads = max(1, d // 64)
    hd = d // n_heads
    xt = x[:, 0]  # (B, D)
    xm = xt + params["shift_mix"] * (cache["x_last"] - xt)

    def heads(t):
        return t.reshape(b, n_heads, hd)

    r = heads(xm @ params["w_r"]).to(torch.float32)
    k = heads(xm @ params["w_k"]).to(torch.float32)
    v = heads(xm @ params["w_v"]).to(torch.float32)
    g = silu(xm @ params["w_g"])
    w = torch.exp(
        -torch.exp((xm @ params["w_decay"]).to(torch.float32) + params["decay_bias"])
    )
    w = heads(w)
    state = cache["state"]  # (B, H, hd, hd)
    u = params["bonus"]
    kv = torch.einsum("bhk,bhl->bhkl", k, v)
    out = torch.einsum("bhk,bhkl->bhl", r, state + u[None, :, :, None] * kv)
    new_state = w[..., None] * state + kv
    out = out.reshape(b, d).to(x.dtype) * g
    out = (out @ params["w_o"])[:, None, :]
    return out, {"state": new_state, "x_last": xt}


def rwkv6_state_init(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    n_heads = max(1, d // 64)
    hd = d // n_heads
    return {
        "state": torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32, device=device),
        "x_last": torch.zeros((batch, d), dtype=cfg.dtype(), device=device),
    }


# RWKV channel mix (used as the 'ffn' for rwkv blocks)


def rwkv_channel_mix_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype()
    return {
        "w_k": dense_init(generator, (d, f), dt),
        "w_v": dense_init(generator, (f, d), dt),
        "w_r": dense_init(generator, (d, d), dt),
        "shift_mix": torch.full((d,), 0.5, dtype=dt, device=generator.device),
    }


def rwkv_channel_mix(params: Params, x: torch.Tensor) -> torch.Tensor:
    xm = x + params["shift_mix"] * (_shift(x) - x)
    k = torch.square(F.relu(torch.einsum("bsd,df->bsf", xm, params["w_k"])))
    kv = torch.einsum("bsf,fd->bsd", k, params["w_v"])
    r = sigmoid(torch.einsum("bsd,de->bse", xm, params["w_r"]))
    return r * kv
