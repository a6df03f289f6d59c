"""Config registry: ``get_config(name)`` for the full assigned configs,
``reduced_config(name)`` for CPU-runnable smoke variants of the same family
(small layers/width/experts/vocab — the assignment's smoke-test rule)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, HybridConfig, MLAConfig, MoEConfig, SSMConfig

from . import (
    deepseek_7b,
    gemma_7b,
    hubert_xlarge,
    internvl2_2b,
    llama4_scout,
    mamba2_130m,
    minicpm3_4b,
    qwen15_110b,
    qwen3_moe_235b,
    recurrentgemma_9b,
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        hubert_xlarge.CONFIG,
        gemma_7b.CONFIG,
        qwen15_110b.CONFIG,
        deepseek_7b.CONFIG,
        minicpm3_4b.CONFIG,
        qwen3_moe_235b.CONFIG,
        llama4_scout.CONFIG,
        mamba2_130m.CONFIG,
        recurrentgemma_9b.CONFIG,
        internvl2_2b.CONFIG,
    ]
}

ARCH_NAMES = list(ARCHS)


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {ARCH_NAMES}") from None


def reduced_config(name: str) -> ArchConfig:
    """Tiny same-family config: one fwd/train step runs on CPU in seconds."""
    cfg = get_config(name)
    kw: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // max(cfg.n_heads, 1), 4)),
        head_dim=16,
        d_ff=128,
        vocab=128,
        logits_chunk=None,
        attn_blockwise_min_seq=64,
        attn_block_q=16,
        attn_block_kv=16,
        n_patches=4,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32
        )
        kw["d_ff"] = 32
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=8, expand=2, n_groups=1, chunk_size=8)
        kw["n_heads"] = 16
        kw["head_dim"] = 8
    if cfg.hybrid is not None:
        kw["n_layers"] = 5  # 1 scanned (rec,rec,attn) super-block + 2 tail
        kw["hybrid"] = HybridConfig(
            pattern=cfg.hybrid.pattern, lru_width=64, conv_width=4, window=16
        )
    return cfg.replace(**kw)
