"""Attention projections (port of ``repro/models/attention.py``): GQA's
parameter layout, qk-norm, bias and RoPE, DeepSeek-V2's multi-head latent
attention (MLA) and the encoder-decoder's cross-attention.  The attention
math lives in ``repro_torch.kernels``.

The KV-representation contract with the cache is the reference's:

* GQA layers cache ``k, v``: (B, S, Hkv, hd) each.
* MLA layers cache the latent ``c`` (B, S, kv_lora) and the single shared
  rope key ``kr`` (B, S, rope_d), not the per-head K/V: the cached forward
  attends over them in the absorbed form (``mla_absorbed_attend``), and
  only training expands them (``mla_self_attention``).
* An encoder-decoder's decoder layers also cache the cross K/V ``ck, cv``
  (B, T, Hkv, hd), computed once from the encoder's output at prefill
  (``cross_attn_kv``) and read by every later forward (``cross_attention``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import attention, attention_plain
from repro_torch.models.common import apply_rope, dense_init, maybe_rope, rmsnorm


def gqa_init(gen, cfg: ModelConfig, dtype, device, d_in: int | None = None) -> dict:
    """GQA's projections from a ``d_in``-wide input (``d_model`` unless
    given: the hybrid's shared block reads ``concat(x, emb0)``, 2 d wide)
    back to ``d_model``."""
    d, hd = d_in or cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.attn_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def gqa_qkv(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> q (B,S,Hq,hd), k,v (B,S,Hkv,hd) with RoPE applied
    (M-RoPE over (B, S, 3) ``positions`` for a config with
    ``mrope_sections``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return maybe_rope(q, positions, cfg), maybe_rope(k, positions, cfg), v


def gqa_out(p, attn: torch.Tensor) -> torch.Tensor:
    B, S = attn.shape[:2]
    return attn.reshape(B, S, -1) @ p["wo"]


def attn_scale(cfg: ModelConfig) -> float:
    if cfg.attn_temperature:
        return cfg.attn_temperature
    if cfg.mla is not None:
        return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)
    return 1.0 / math.sqrt(cfg.resolved_head_dim)


# --------------------------------------------------------------- MLA


def mla_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    m, d = cfg.mla, cfg.d_model
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    H = cfg.n_heads
    return {
        "w_dq": dense_init(gen, d, m.q_lora_rank, dtype, device),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype, device=device),
        "w_uq": dense_init(gen, m.q_lora_rank, H * qk_hd, dtype, device),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank, dtype, device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
        "w_kr": dense_init(gen, d, m.qk_rope_head_dim, dtype, device),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim, dtype, device),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype, device),
        "wo": dense_init(gen, H * m.v_head_dim, d, dtype, device),
    }


def mla_latent(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """The cacheable latent: c (B, S, kv_lora) and the rope key (B, S,
    rope_d), RoPE applied to it as a single shared head."""
    c = rmsnorm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = (x @ p["w_kr"])[:, :, None, :]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return c, k_rope[:, :, 0, :]


def mla_q(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """q_nope (B, S, H, nope) and q_rope (B, S, H, rope_d), RoPE applied."""
    m = cfg.mla
    B, S, _ = x.shape
    q = rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps) @ p["w_uq"]
    q = q.reshape(B, S, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_self_attention(p, x: torch.Tensor, positions: torch.Tensor,
                       pos1d: torch.Tensor, cfg: ModelConfig, *,
                       window: int = 0):
    """Full-sequence causal MLA in the expanded form (training, on the
    plain attention as the reference's trainer runs it): per-head K/V
    (nope + rope, v) are made from the latent for this call only.  Returns
    (y (B, S, d), (c, k_rope))."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = mla_q(p, x, positions, cfg)
    c, k_rope = mla_latent(p, x, positions, cfg)
    k_nope = (c @ p["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (c @ p["w_uv"]).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    o = attention_plain(q, k, v, pos1d, pos1d, causal=True, window=window,
                        scale=attn_scale(cfg))
    return o.reshape(B, S, -1) @ p["wo"], (c, k_rope)


def mla_absorbed_attend(p, q_nope: torch.Tensor, q_rope: torch.Tensor,
                        pos1d: torch.Tensor, cfg: ModelConfig,
                        cache_c: torch.Tensor, cache_kr: torch.Tensor,
                        kv_pos: torch.Tensor, *, window: int = 0,
                        attn_impl: str = "auto") -> torch.Tensor:
    """Cached MLA in the absorbed form: one attention over the latent cache
    as multi-query attention with head dim kv_lora + rope_d and value dim
    kv_lora (``cache_c`` (B, C, r) and ``cache_kr`` (B, C, rope_d) already
    hold the new tokens)::

        score_h = (q_nope_h W_uk_h) . c  +  q_rope_h . k_rope
        out_h   = (attn . c) W_uv_h

    Returns y (B, m, d), through the output projection."""
    m = cfg.mla
    B, S = q_nope.shape[:2]
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)           # (B, m, H, r)
    q_cat = torch.cat([q_eff, q_rope], dim=-1)                     # (B, m, H, r + rope)
    k_cat = torch.cat([cache_c, cache_kr], dim=-1)[:, :, None, :]  # one kv head
    # the values are the latent: k_cat's first r columns, the same values
    # as cache_c, handed as that view (the MLA kernel reads V out of K)
    v_lat = k_cat[..., :m.kv_lora_rank]
    o_lat = attention(q_cat, k_cat, v_lat, pos1d, kv_pos, causal=True,
                      window=window, scale=attn_scale(cfg), impl=attn_impl)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, cfg.n_heads, m.v_head_dim)
    o = torch.einsum("bshr,rhd->bshd", o_lat, w_uv)
    return o.reshape(B, S, -1) @ p["wo"]


# --------------------------------------------------------------- cross-attn


def cross_attn_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    return gqa_init(gen, cfg, dtype, device)


def cross_attention(p, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, enc_pos: torch.Tensor,
                    cfg: ModelConfig, *, attn_impl: str = "auto") -> torch.Tensor:
    """Encoder-decoder cross-attention: x (B, S, d) decoder states against
    the encoder's cached K/V (B, T, Hkv, hd) at ``enc_pos`` (B, T).  q gets
    no RoPE; every q position is 0 and the attention is not causal, so
    each query sees every valid frame.  Through ``attention`` at every
    query width, as in the reference.  Returns y (B, S, d)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    q_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    o = attention(q, enc_k, enc_v, q_pos, enc_pos, causal=False,
                  scale=attn_scale(cfg), impl=attn_impl)
    return gqa_out(p, o)


def cross_attn_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross K/V (B, T, Hkv, hd) of one decoder layer from the encoder's
    output (B, T, d), made once at prefill."""
    B, T, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ p["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = (enc_out @ p["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v
