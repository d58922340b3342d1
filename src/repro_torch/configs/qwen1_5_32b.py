"""qwen1.5-32b [dense]: QKV-bias dense transformer.

64L d_model=5120 40H (GQA kv=40 = MHA) d_ff=27392 vocab=152064
[hf:Qwen/Qwen1.5-0.5B; hf].
"""

from ..models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    period=(LayerSpec(mixer="attention", ffn="dense"),),
    qkv_bias=True,
    # full MHA (kv=40): the 32k decode cache is 21.5 GiB/chip in bf16 --
    # int8 KV quantization is what makes this arch servable on v5e
    kv_cache_dtype="int8",
    supports_long_context=False,
    max_seq_len=32768,
)
