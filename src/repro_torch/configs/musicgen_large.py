"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 = full MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec audio frontend is a stub: precomputed
frame embeddings arrive via ``prefix_embeddings`` (see launch/specs.py).
"""

from ..models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    period=(LayerSpec(mixer="attention", ffn="dense"),),
    prefix_len=256,  # EnCodec frame-embedding stub
    supports_long_context=False,  # pure full attention: skip long_500k
    max_seq_len=32768,
)
