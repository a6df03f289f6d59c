"""Architecture + shape configuration system (a copy of ``repro.models.config``).

Every assigned architecture is expressed as an :class:`ArchConfig`; the four
assigned input shapes as :class:`ShapeSpec`.  Configs are pure data, kept
identical to the JAX package's so one config names the same model in both.

The port reads the model fields (widths, heads, vocab, activation, biases,
norms, RoPE, window, softcap, dtype).  The JAX package's XLA / Pallas knobs
(``use_pallas``, ``attn_blockwise_min_seq``, ``attn_mode``, block sizes,
``kv_update``, ``kv_shard``, ``remat``, ``scan_layers``, ``probe_unroll``,
``act_shard``, ``logits_chunk``) have no effect here: on the card every
attention call goes through the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # 'einsum'  — GShard one-hot dispatch (baseline; inflates HLO FLOPs)
    # 'scatter' — sort/scatter dispatch (optimized; matmul FLOPs ≈ useful)
    dispatch: str = "einsum"
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (state-space duality)."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma / Griffin: RG-LRU blocks interleaved with local attn."""

    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: Optional[int] = None  # defaults to d_model
    conv_width: int = 4
    window: int = 2048


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_window: Optional[int] = None  # sliding-window size, None = full
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scale
    logit_softcap: Optional[float] = None

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # modality frontend stub: None | 'audio' | 'vision'
    frontend: Optional[str] = None
    # for vlm: number of image patch positions prepended to the text sequence
    n_patches: int = 256

    # ---- numerics / performance knobs (the §Perf levers) -------------------
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots_saveable
    scan_layers: bool = True
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    # 'masked': every (q,kv) block pair computed+masked (baseline)
    # 'tri': causal/window block ranges honoured structurally (~half FLOPs)
    # 'auto': tri when query heads divide the mesh model axis (§Perf)
    attn_mode: str = "masked"
    # materialize-scores threshold: below this seq len the simple reference
    # attention is used; above, the blockwise (flash-style) scan
    attn_blockwise_min_seq: int = 2048
    use_pallas: bool = False
    logits_chunk: Optional[int] = None  # chunked cross-entropy over sequence
    optimizer: str = "adamw"  # adamw | adafactor
    opt_state_dtype: str = "float32"
    kv_update: str = "onehot"  # onehot | dus
    # decode KV cache layout: 'seq' shards the cache sequence dim over the
    # model axis (flash-decoding combine); 'heads' shards kv heads instead
    # (local updates — pairs with kv_update='dus'; needs n_kv % model == 0)
    kv_shard: str = "seq"
    # embedding/logits tables are allocated padded to this multiple so the
    # vocab dim shards on any mesh (Megatron-style vocab padding); pad
    # logits are masked to −inf in the loss. 128 covers model≤128 × lanes.
    vocab_pad_multiple: int = 128
    # probe mode: unroll inner loops (flash kv blocks, CE chunks) so XLA
    # cost_analysis counts them; deployable configs keep lax.scan (memory)
    probe_unroll: bool = False
    # activation sharding for the scan carry: 'seq' (Megatron-SP-like) or
    # 'embed' or 'none'
    act_shard: str = "seq"

    # ------------------------------------------------------------------ utils

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def is_encoder(self) -> bool:
        return self.family == "encoder"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k (bounded per-token state)?"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True
        return self.attn_window is not None

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (MODEL_FLOPS = 6·N·D; N_active for MoE) ---------

    def param_count(self) -> int:
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        return _count_params(self, active_only=True)


def _count_params(cfg: ArchConfig, active_only: bool) -> int:
    d = cfg.d_model
    n = 0
    # embeddings (+ untied head)
    n += cfg.vocab * d
    if not cfg.tie_embeddings:
        n += cfg.vocab * d

    def attn_params() -> int:
        if cfg.mla is not None:
            m = cfg.mla
            p = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim
            )
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += cfg.n_heads * m.v_head_dim * d
            return p
        q = d * cfg.n_heads * cfg.head_dim
        kv = 2 * d * cfg.n_kv_heads * cfg.head_dim
        o = cfg.n_heads * cfg.head_dim * d
        b = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim if cfg.qkv_bias else 0
        return q + kv + o + b

    def mlp_params(ff: int) -> int:
        mult = 3 if cfg.act in ("swiglu", "geglu") else 2
        return mult * d * ff

    def ssm_params() -> int:
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
        p += d_in * d  # out_proj
        p += 4 * (d_in + 2 * s.n_groups * s.d_state)  # conv
        p += 2 * nh  # A_log, D
        return p

    def rglru_params() -> int:
        h = cfg.hybrid
        w = h.lru_width or d
        p = 2 * d * w  # in_proj (x and gate branches)
        p += h.conv_width * w  # temporal conv
        p += 2 * w  # Lambda, input-gate params (diagonal)
        p += 2 * w * w  # recurrent/input gates (per-channel dense blocks, approx)
        p += w * d  # out_proj
        return p

    for li in range(cfg.n_layers):
        n += 2 * d  # two rmsnorm scales
        if cfg.family == "ssm":
            n += ssm_params()
            continue
        if cfg.family == "hybrid":
            kind = cfg.hybrid.pattern[li % len(cfg.hybrid.pattern)]
            n += rglru_params() if kind == "rec" else attn_params()
            n += mlp_params(cfg.d_ff)
            continue
        n += attn_params()
        if cfg.moe is not None:
            e_params = mlp_params(cfg.moe.d_ff_expert)
            n_routed = cfg.moe.top_k if active_only else cfg.moe.n_experts
            n += n_routed * e_params
            n += cfg.moe.n_shared_experts * e_params
            n += d * cfg.moe.n_experts  # router
        else:
            n += mlp_params(cfg.d_ff)
    n += d  # final norm
    return n


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeSpec]:
    """The assigned-cell rules: encoder-only archs have no
    decode shapes; ``long_500k`` only for sub-quadratic archs."""
    out = []
    for s in SHAPES.values():
        if s.kind == "decode" and not cfg.supports_decode:
            continue
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return out
