"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E].  48L d_model=5120 40H (kv=8)
expert d_ff=8192 vocab=202048.  The early-fusion modality frontend is out of
scope for the LM backbone cells (text path only, per assignment note)."""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    act="swiglu",
    rope_theta=500_000.0,
    logits_chunk=1024,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared_experts=1),
)
