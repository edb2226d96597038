"""Model configuration: the dense-decoder, Mamba2 (``arch_type="ssm"``),
mixture-of-experts (``arch_type="moe"``), multi-head latent attention
(``mla``), Zamba2-style hybrid (``arch_type="hybrid"``),
encoder-decoder (``arch_type="encdec"``) and vision-language
(``arch_type="vlm"``: M-RoPE, stub image patches) parts of the JAX
package's ``ModelConfig``, ``SSMConfig``, ``MoEConfig`` and ``MLAConfig`` (``repro/configs/base.py``), copied so the
port imports nothing of ``repro``.  Field names and defaults are the reference's, so a config built
here describes the same model as its JAX twin.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Literal

Activation = Literal["silu", "geglu", "gelu"]


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (DeepSeek-style fine-grained MoE)."""

    n_routed: int = 0                 # number of routed experts
    n_shared: int = 0                 # always-on shared experts
    top_k: int = 0                    # experts per token
    d_expert: int = 0                 # hidden dim of each expert FFN
    first_k_dense: int = 1            # leading layers that use a dense FFN
    dense_d_ff: int = 0               # d_ff of those dense layers
    capacity_factor: float = 1.25     # expert-parallel capacity factor
    router_aux_weight: float = 0.001  # load-balance aux loss weight
    routed_scale: float = 1.0         # scaling on routed output (DeepSeek uses 1.0)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) sub-config."""

    d_state: int = 128
    head_dim: int = 64                # P in SSD
    expand: int = 2                   # d_inner = expand * d_model
    chunk: int = 128                  # SSD chunk length
    conv_width: int = 4
    n_groups: int = 1                 # B/C groups (like GQA for SSM)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention sub-config."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    arch_type: str = "dense"
    source: str = ""                  # citation: arXiv id / model card

    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab: int = 256

    activation: Activation = "silu"
    qk_norm: bool = False
    attn_bias: bool = False           # qwen1.5-style qkv bias
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma: scale embeddings by sqrt(d)
    rmsnorm_one_plus: bool = False    # gemma: (1 + w) * normed
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w)
    logit_softcap: float = 0.0

    sliding_window: int = 0           # 0 = full attention; >0 = SWA window
    attn_temperature: float = 0.0     # 0 -> 1/sqrt(head_dim)

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None

    # hybrid: the block kinds of one group, tiled over the depth ("ssm" or
    # "shared_attn": one attention+MLP block whose weights every group shares)
    hybrid_pattern: tuple[str, ...] = ()

    # encoder-decoder: the encoder's layer count; the encoder reads stub
    # frontend frames (precomputed d_model-wide embeddings), encoder_len of
    # them per example
    n_encoder_layers: int = 0
    encoder_len: int = 1024

    # vlm: number of stub image-patch embeddings prepended to the stream
    n_image_patches: int = 0

    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a multiple of 256 (the
        reference's layout; logits beyond ``vocab`` are masked)."""
        return -(-self.vocab // 256) * 256

    def block_kinds(self) -> tuple[str, ...]:
        """Per-layer block kind sequence."""
        if self.arch_type == "ssm":
            return ("ssm",) * self.n_layers
        if self.arch_type == "hybrid":
            pat = self.hybrid_pattern or ("ssm", "ssm", "ssm", "ssm", "ssm", "shared_attn")
            reps = math.ceil(self.n_layers / len(pat))
            return (pat * reps)[: self.n_layers]
        return ("attn",) * self.n_layers

    def moe_layer_mask(self) -> tuple[bool, ...]:
        """True where the FFN is MoE (False = dense FFN): every layer from
        ``first_k_dense`` on, as in the reference's ``init_stack``."""
        if self.moe is None or self.moe.n_routed == 0:
            return (False,) * self.n_layers
        return tuple(i >= self.moe.first_k_dense for i in range(self.n_layers))

    def reduced(self) -> "ModelConfig":
        """The reference's CPU-test variant of this config: 2 layers, width
        at most 128, vocab at most 512, heads of 32, at most 4 experts,
        float32, a hybrid one group deep, an encoder of 2 layers over 32
        frames, 8 image patches and M-RoPE sections (4, 6, 6) (the dense,
        MoE, SSM, MLA, hybrid, encoder-decoder and VLM fields of
        ``ModelConfig.reduced``)."""
        n_heads = max(2, min(self.n_heads, 4))
        kw: dict = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=min(self.d_model, 128),
            vocab=min(self.vocab, 512),
            n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads, n_heads)),
            head_dim=32,
            d_ff=min(self.d_ff, 256) or 256,
            dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe,
                n_routed=min(self.moe.n_routed, 4),
                n_shared=min(self.moe.n_shared, 1),
                top_k=min(self.moe.top_k, 2),
                d_expert=64,
                first_k_dense=min(self.moe.first_k_dense, 1),
                dense_d_ff=128 if self.moe.dense_d_ff else 0,
            )
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32,
            )
        if self.hybrid_pattern:
            kw["n_layers"] = max(2, len(self.hybrid_pattern))
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
            kw["encoder_len"] = 32
        if self.n_image_patches:
            kw["n_image_patches"] = 8
        if self.mrope_sections:
            kw["mrope_sections"] = (4, 6, 6)  # sums to head_dim // 2 = 16
        return replace(self, **kw)


REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _  # noqa: F401  (registration)

    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
