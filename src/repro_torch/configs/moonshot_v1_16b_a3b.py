"""moonshot-v1-16b-a3b [moe]: Moonlight 64-expert top-6 MoE.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].
"""

from ..models.config import ArchConfig, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    period=(LayerSpec(mixer="attention", ffn="moe"),),
    moe=MoEConfig(num_experts=64, top_k=6),
    supports_long_context=False,
    max_seq_len=32768,
)
