"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].
LM backbone: 24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92553.
The InternViT frontend is a STUB: ``input_specs`` feeds precomputed patch
embeddings (B, n_patches, 1024) projected into the LM sequence."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    act="swiglu",
    frontend="vision",
    logits_chunk=768,
    n_patches=256,
)
