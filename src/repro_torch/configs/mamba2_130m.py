"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].
24L d_model=768, attn-free, vocab=50280, ssm_state=128.
d_inner = 2·768 = 1536 → 24 heads of head_dim 64.  Sub-quadratic: runs the
long_500k cell (O(1)-state decode)."""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    logits_chunk=1024,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, chunk_size=256),
)
