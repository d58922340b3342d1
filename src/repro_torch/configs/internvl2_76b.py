"""internvl2-76b [vlm]: InternLM2-style dense backbone (InternViT stubbed).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified].  The ViT frontend is a stub: precomputed
patch embeddings arrive via ``prefix_embeddings``.
"""

from ..models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    period=(LayerSpec(mixer="attention", ffn="dense"),),
    prefix_len=256,  # ViT patch-embedding stub
    supports_long_context=False,
    max_seq_len=32768,
)
