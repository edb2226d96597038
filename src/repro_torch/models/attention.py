"""GQA attention projections (port of the GQA part of
``repro/models/attention.py``): parameter layout, qk-norm, bias and RoPE.
The attention math lives in ``repro_torch.kernels``."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_rope, dense_init, rmsnorm


def gqa_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device),
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
    """x: (B, S, d) -> q (B,S,Hq,hd), k,v (B,S,Hkv,hd) with RoPE applied."""
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
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_out(p, attn: torch.Tensor) -> torch.Tensor:
    B, S = attn.shape[:2]
    return attn.reshape(B, S, -1) @ p["wo"]


def attn_scale(cfg: ModelConfig) -> float:
    if cfg.attn_temperature:
        return cfg.attn_temperature
    return 1.0 / math.sqrt(cfg.resolved_head_dim)
