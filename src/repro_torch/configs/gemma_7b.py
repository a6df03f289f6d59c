"""gemma-7b [dense] — GeGLU, head_dim=256, MHA (kv=16) [arXiv:2403.08295].
28L d_model=3072 16H d_ff=24576 vocab=256000; tied embeddings, sqrt(d)
embedding scale; chunked CE for the 256k vocab."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    logits_chunk=1024,
)
