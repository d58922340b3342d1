"""phi4-mini-3.8b [dense]: RoPE + SwiGLU + GQA with a 200k vocabulary.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064
[arXiv:2412.08905; hf].  Tied input/output embeddings.
"""

from ..models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    period=(LayerSpec(mixer="attention", ffn="dense"),),
    tie_embeddings=True,
    supports_long_context=False,
    max_seq_len=32768,
)
