"""qwen1.5-110b [dense] — GQA kv=8, QKV bias [hf:Qwen/Qwen1.5 family].
80L d_model=8192 64H d_ff=49152 vocab=152064."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab=152064,
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    logits_chunk=1024,
)
