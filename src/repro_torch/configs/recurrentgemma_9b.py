"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427].  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, window 2048.  Sub-quadratic: runs long_500k (ring-buffer KV of
window size + recurrent state)."""
from repro_torch.models.config import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    logits_chunk=1024,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=4096, conv_width=4, window=2048),
)
