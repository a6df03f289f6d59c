"""minicpm3-4b [dense, MLA] — multi-head latent attention
[hf:openbmb/MiniCPM3-4B].  62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA: q_lora=768, kv_lora=256, nope=64, rope=32, v=64 — the decode cache
stores only (c_kv, k_rope): ~(256+32) vs 2·40·64 floats/token for GQA."""
from repro_torch.models.config import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab=73448,
    act="swiglu",
    logits_chunk=1024,
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
)
