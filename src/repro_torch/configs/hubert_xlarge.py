"""hubert-xlarge [audio] — encoder-only, wav2vec2 architecture
[arXiv:2106.07447].  48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

The conv feature-extractor frontend is a STUB: ``input_specs`` feeds
precomputed frame embeddings (B, L, 512); training is masked-prediction CE
over the 504 k-means units.  Encoder-only ⇒ no decode shapes.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    act="gelu",
    frontend="audio",
    rope_theta=10000.0,
)
