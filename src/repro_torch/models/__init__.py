"""Every block kind of ``repro`` (``attn``, ``mla``, ``moe``, ``ssm``, ``rec``
and the recurrentgemma hybrid) and its audio and vision frontends as
``nn.Module``s, with the JAX package's weight layouts and function names
(all of ``repro.models``')."""
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
from repro_torch.models.layers import gather_logits, greedy_tokens
from repro_torch.models.transformer import (
    Block,
    MeshCaches,
    abstract_cache,
    abstract_inputs,
    abstract_params,
    embed_inputs,
    head_logits,
    input_defs,
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
    param_shardings,
    prefill,
    set_trainable,
    verify_step,
)

__all__ = [
    "ArchConfig", "HybridConfig", "MLAConfig", "MoEConfig", "SHAPES", "ShapeSpec",
    "SSMConfig", "applicable_shapes", "abstract_cache", "abstract_inputs", "abstract_params",
    "embed_inputs", "head_logits", "input_defs", "Block", "RecBlock", "SSMBlock", "Transformer", "block_kind", "cache_defs",
    "cache_layout", "decode_step", "forward", "gather_logits", "greedy_tokens", "init_cache", "init_params",
    "MeshCaches",
    "layer_kinds", "leaf_layout", "loss_fn", "model_defs", "param_shardings", "prefill", "set_trainable", "verify_step",
]
