"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, QK-norm
[hf:Qwen/Qwen3 family].  94L d_model=4096 64H (kv=4) expert d_ff=1536
vocab=151936.  Experts shard over the model axis (EP); dispatch strategy is
the §Perf lever (einsum baseline vs scatter)."""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    act="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    logits_chunk=1024,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
)
