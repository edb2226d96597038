"""Shared model building blocks: norms, RoPE, MLPs, embeddings, and the
seeded initialisers (port of ``repro/models/common.py``).

Dtype discipline is the reference's: ``rmsnorm`` and ``apply_rope`` compute
in float32 and cast back to the storage dtype; everything else runs in the
storage dtype.  Weights keep JAX's ``(d_in, d_out)`` layout (``x @ W``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ----------------------------------------------------------------- init


def normal_init(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device, scale: float = 1.0):
    return normal_init(gen, (in_dim, out_dim), scale / math.sqrt(in_dim), dtype, device)


def rmsnorm_init(d: int, dtype, device, one_plus: bool = False) -> torch.Tensor:
    # gemma stores (1+w); init w=0 <=> scale 1
    fill = 0.0 if one_plus else 1.0
    return torch.full((d,), fill, dtype=dtype, device=device)


# ----------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            one_plus: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if one_plus else w.float()
    return (xf * scale).to(dt)


# ----------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S) integer.
    Half-rotation ("rotate_half", llama) convention."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    angles = positions[..., None].float() * freqs             # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- mlp


def mlp_init(gen, cfg: ModelConfig, d_ff: int, dtype, device) -> dict:
    d = cfg.d_model
    p = {
        "w_up": dense_init(gen, d, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d, dtype, device),
    }
    if cfg.activation in ("silu", "geglu"):
        p["w_gate"] = dense_init(gen, d, d_ff, dtype, device)
    return p


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.activation == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    else:  # gelu
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]


# ----------------------------------------------------------------- embed


def embed_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    v = cfg.padded_vocab
    p = {"embedding": normal_init(gen, (v, cfg.d_model), 0.02, dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, v, dtype, device)
    return p


def embed_apply(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["embedding"][tokens]
    if cfg.embed_scale:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def unembed_matrix(p, cfg: ModelConfig) -> torch.Tensor:
    """(d, Vp) unembedding; for tied configs a transposed VIEW of the
    (Vp, d) embedding table (never copied)."""
    return p["embedding"].t() if cfg.tie_embeddings else p["lm_head"]


def lm_head_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    logits = x @ unembed_matrix(p, cfg)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
