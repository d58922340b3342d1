"""Architecture configuration.

A model is a stack of ``n_periods`` identical *periods*; each period is a
static list of :class:`LayerSpec` (mixer + ffn choice).  Dense transformers
have period length 1; Jamba's 1:7 attention:Mamba interleave with MoE on
alternate layers is a period of 8.  Parameters are stacked along the period
axis so the whole depth lowers as one ``lax.scan`` (compile time and HBM
win; see DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside a period."""

    mixer: str = "attention"  # attention | mamba | rwkv6
    ffn: str = "dense"  # dense | moe | none (rwkv6 has its own channel mix)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # Arctic-style dense FFN residual evaluated in parallel with the MoE
    dense_residual_ff: int = 0


@dataclass(frozen=True)
class ArchConfig:
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_head: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 256
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # SSM (mamba) geometry
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # modality frontend stub: number of prefix embedding positions
    prefix_len: int = 0
    # numerics
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    optimizer_state_dtype: str = "float32"  # bf16 for the >300B MoE archs
    kv_cache_dtype: str = "bfloat16"  # "int8" halves+ decode-cache HBM (MHA archs)
    # pure full-attention archs skip long_500k (needs sub-quadratic mixer)
    supports_long_context: bool = False
    max_seq_len: int = 8192

    def __post_init__(self):
        assert self.n_layers % len(self.period) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by period "
            f"{len(self.period)}"
        )

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the logits dim shards on any mesh
        (MaxText-style padding; granite's 49155 -> 49408).  Padded logit
        positions are masked to -inf in ``unembed``."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.activation_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # output head
        for spec in self.period:
            block = 0
            if spec.mixer == "attention":
                block += d * self.n_heads * hd  # q
                block += 2 * d * self.n_kv_heads * hd  # k, v
                block += self.n_heads * hd * d  # o
            elif spec.mixer == "mamba":
                di = self.d_inner
                block += d * 2 * di  # in_proj (x, z)
                block += di * self.ssm_conv  # conv
                block += di * (2 * self.ssm_state + 1)  # B, C, dt proj
                block += di * self.ssm_state  # A
                block += di * d  # out_proj
            elif spec.mixer == "rwkv6":
                block += 4 * d * d  # r, k, v, output
                block += d * d  # gate
            if spec.ffn == "dense":
                block += 3 * d * f  # swiglu gate/up/down
            elif spec.ffn == "moe" and self.moe is not None:
                block += d * self.moe.num_experts  # router
                block += self.moe.num_experts * 3 * d * f
                if self.moe.dense_residual_ff:
                    block += 3 * d * self.moe.dense_residual_ff
            elif spec.ffn == "none" and spec.mixer == "rwkv6":
                block += 2 * d * f + d * d  # rwkv channel-mix
            block += 2 * d  # norms
            total += block * self.n_periods
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE uses top_k of num_experts."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        n_moe_layers = sum(1 for s in self.period if s.ffn == "moe") * self.n_periods
        inactive = (self.moe.num_experts - self.moe.top_k) * 3 * d * f * n_moe_layers
        return total - inactive

    def reduced(self, **overrides) -> "ArchConfig":
        """A smoke-test-sized config of the same family (same period
        structure, tiny dims)."""
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe,
                num_experts=min(moe.num_experts, 4),
                top_k=min(moe.top_k, 2),
                dense_residual_ff=64 if moe.dense_residual_ff else 0,
            )
        base = dataclasses.replace(
            self,
            n_layers=len(self.period) * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128,
            vocab_size=512,
            moe=moe,
            prefix_len=min(self.prefix_len, 4),
            max_seq_len=128,
        )
        return dataclasses.replace(base, **overrides)
