"""Mixture-of-Experts FFN with capacity-based einsum dispatch, in PyTorch.

The JAX package's ``models/moe.py`` function for function.  Tokens are
split into groups of ``GROUP_SIZE``; within a group each token's top-k
experts are assigned a capacity slot by cumulative sums (k=0 first), and
dispatch and combine are one-hot einsums.  Tokens overflowing an expert's
capacity lose that expert (Switch behaviour); ``capacity_factor`` sets the
capacity.  The dispatch einsum reads every expert's weights, as the
reference's does.

Arctic's dense-residual variant evaluates a small dense SwiGLU in parallel
with the MoE and sums the results.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import ArchConfig, MoEConfig
from .layers import dense_init, silu, swiglu, swiglu_init

Params = Dict[str, Any]

GROUP_SIZE = 1024  # tokens per dispatch group


def moe_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    moe = cfg.moe
    assert moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, moe.num_experts
    dt = cfg.pdtype()
    params = {
        "router": dense_init(generator, (d, e), torch.float32),  # fp32 routing
        "w_gate": dense_init(generator, (e, d, f), dt),
        "w_up": dense_init(generator, (e, d, f), dt),
        "w_down": dense_init(generator, (e, f, d), dt),
    }
    if moe.dense_residual_ff:
        params["dense_residual"] = swiglu_init(generator, cfg, moe.dense_residual_ff)
    return params


def _capacity(moe: MoEConfig, group_tokens: int) -> int:
    cap = int(np.ceil(group_tokens * moe.top_k / moe.num_experts * moe.capacity_factor))
    return max(cap, moe.top_k)


def _one_hot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside 0..n-1 gives a row of zeros."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(dtype)


def moe_apply(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    moe = cfg.moe
    b, s, d = x.shape
    tokens = b * s
    g_size = min(GROUP_SIZE, tokens)
    assert tokens % g_size == 0, (tokens, g_size)
    n_groups = tokens // g_size
    e = moe.num_experts
    cap = _capacity(moe, g_size)

    xg = x.reshape(n_groups, g_size, d)
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32), params["router"])
    probs = torch.softmax(logits, dim=-1)  # (G, T, E)

    # top-k selection, then capacity slots via cumulative position
    top_probs, top_idx = torch.topk(probs, moe.top_k, dim=-1)  # (G, T, K)
    # normalise the k gate weights
    top_probs = top_probs / torch.clamp(top_probs.sum(-1, keepdim=True), min=1e-9)

    combine = torch.zeros((n_groups, g_size, e, cap), dtype=x.dtype, device=x.device)
    # slot occupancy is computed per expert across the k selections in order
    # (k=0 has priority), matching Switch/MTF semantics
    expert_onehot_prev = torch.zeros((n_groups, g_size, e), dtype=torch.int32, device=x.device)
    for k in range(moe.top_k):
        sel = _one_hot(top_idx[..., k], e, torch.int32)  # (G, T, E)
        # position of this token within the expert = tokens (and earlier-k
        # picks) before it choosing the same expert
        prior = torch.cumsum(sel, dim=1) - sel + torch.cumsum(expert_onehot_prev, dim=1)
        pos = torch.sum(sel * prior, dim=-1)  # (G, T)
        keep = pos < cap
        gate = (top_probs[..., k] * keep).to(x.dtype)  # dropped tokens lose this expert
        slot = _one_hot(pos, cap, x.dtype)  # (G, T, C)
        combine = combine + (
            gate[..., None, None] * sel[..., :, None].to(x.dtype) * slot[..., None, :]
        )
        expert_onehot_prev = expert_onehot_prev + sel

    dispatch = (combine > 0).to(x.dtype)  # (G, T, E, C)
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xg)  # (G, E, C, D)

    gate_p = silu(torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"]))
    up_p = torch.einsum("gecd,edf->gecf", expert_in, params["w_up"])
    expert_out = torch.einsum("gecf,efd->gecd", gate_p * up_p, params["w_down"])

    out = torch.einsum("gtec,gecd->gtd", combine, expert_out).reshape(b, s, d)

    if moe.dense_residual_ff:
        out = out + swiglu(params["dense_residual"], x)
    return out


def aux_load_balance_loss(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (mean over groups)."""
    moe = cfg.moe
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    density = torch.mean(_one_hot(top1, moe.num_experts, torch.float32), dim=(0, 1))
    density_proxy = torch.mean(probs, dim=(0, 1))
    return moe.num_experts * torch.sum(density * density_proxy)
