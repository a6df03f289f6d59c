"""The dense transformer (block kind ``"attn"``) and the Mamba-2 stack (block
kind ``"ssm"``) as ``nn.Module``s, with the JAX package's weight layouts and
function names."""
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
    SSMBlock,
    Transformer,
    cache_defs,
    cache_layout,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    model_defs,
    prefill,
    set_trainable,
    verify_step,
)

__all__ = [
    "ArchConfig", "HybridConfig", "MLAConfig", "MoEConfig", "SHAPES", "ShapeSpec",
    "SSMConfig", "applicable_shapes", "Block", "SSMBlock", "Transformer", "cache_defs",
    "cache_layout", "decode_step", "forward", "init_cache", "init_params",
    "loss_fn", "model_defs", "prefill", "set_trainable", "verify_step",
]
