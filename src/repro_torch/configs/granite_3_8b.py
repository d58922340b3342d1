"""granite-3-8b [dense]: GQA dense transformer.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base; hf].
"""

from ..models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    period=(LayerSpec(mixer="attention", ffn="dense"),),
    supports_long_context=False,
    max_seq_len=32768,
)
