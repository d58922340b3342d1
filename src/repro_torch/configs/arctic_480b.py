"""arctic-480b [moe]: 128-expert top-2 MoE with a parallel dense residual.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base; hf].  Dense-MoE hybrid: every layer
evaluates a small dense SwiGLU in parallel with the MoE.  Optimizer
moments bf16 (480B total parameters; DESIGN.md §5).
"""

from ..models.config import ArchConfig, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    period=(LayerSpec(mixer="attention", ffn="moe"),),
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual_ff=4864),
    optimizer_state_dtype="bfloat16",
    supports_long_context=False,
    max_seq_len=32768,
)
