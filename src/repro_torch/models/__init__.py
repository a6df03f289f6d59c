"""The dense transformer (block kind ``"attn"``) as ``nn.Module``s, with the
JAX package's weight layouts and function names."""
from repro_torch.models.config import (
    ArchConfig,
    HybridConfig,
    MLAConfig,
    MoEConfig,
    SHAPES,
    ShapeSpec,
    SSMConfig,
    applicable_shapes,
)
from repro_torch.models.transformer import (
    Block,
    Transformer,
    cache_defs,
    cache_layout,
    decode_step,
    forward,
    init_cache,
    init_params,
    model_defs,
    prefill,
)

__all__ = [
    "ArchConfig", "HybridConfig", "MLAConfig", "MoEConfig", "SHAPES", "ShapeSpec",
    "SSMConfig", "applicable_shapes", "Block", "Transformer", "cache_defs",
    "cache_layout", "decode_step", "forward", "init_cache", "init_params",
    "model_defs", "prefill",
]
