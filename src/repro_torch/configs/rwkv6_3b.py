"""rwkv6-3b [ssm]: Finch -- attention-free, data-dependent decay.

32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 [arXiv:2404.05892; hf].
Time-mix (rwkv6) + channel-mix blocks; O(1)-state decode runs long_500k.
"""

from ..models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # rwkv head count: d_model / 64
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    period=(LayerSpec(mixer="rwkv6", ffn="none"),),
    supports_long_context=True,
    max_seq_len=524288,
)
