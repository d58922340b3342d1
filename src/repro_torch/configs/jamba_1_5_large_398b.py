"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave with MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf].  Period of 8 layers: one attention layer (index 4)
among seven Mamba layers; MoE replaces the dense FFN on every other layer.
Optimizer moments are kept in bf16 (398B params must fit v5e HBM;
DESIGN.md §5).
"""

from ..models.config import ArchConfig, LayerSpec, MoEConfig

_PERIOD = tuple(
    LayerSpec(
        mixer="attention" if i == 4 else "mamba",
        ffn="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    period=_PERIOD,
    moe=MoEConfig(num_experts=16, top_k=2),
    optimizer_state_dtype="bfloat16",
    supports_long_context=True,  # SSM-dominant: runs long_500k
    max_seq_len=524288,
)
