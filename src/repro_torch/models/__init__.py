"""Every block kind of ``repro`` (``attn``, ``mla``, ``moe``, ``ssm``, ``rec``
and the recurrentgemma hybrid) as ``nn.Module``s, with the JAX package's
weight layouts and function names."""
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
    RecBlock,
    SSMBlock,
    Transformer,
    block_kind,
    cache_defs,
    cache_layout,
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_kinds,
    leaf_layout,
    loss_fn,
    model_defs,
    prefill,
    set_trainable,
    verify_step,
)

__all__ = [
    "ArchConfig", "HybridConfig", "MLAConfig", "MoEConfig", "SHAPES", "ShapeSpec",
    "SSMConfig", "applicable_shapes", "Block", "RecBlock", "SSMBlock", "Transformer", "block_kind", "cache_defs",
    "cache_layout", "decode_step", "forward", "init_cache", "init_params",
    "layer_kinds", "leaf_layout", "loss_fn", "model_defs", "prefill", "set_trainable", "verify_step",
]
