"""Shared model building blocks: norms, RoPE, MLPs, embeddings, and the
seeded initialisers (port of ``repro/models/common.py``).

Dtype discipline is the reference's: ``rmsnorm``, ``apply_rope`` and
``apply_mrope`` compute in float32 and cast back to the storage dtype;
everything else runs in the storage dtype.  Weights keep JAX's ``(d_in,
d_out)`` layout (``x @ W``).
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
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (d/2,)
    return _rotate_half(x, positions[..., None].float() * freqs)


def _rotate_half(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated by ``angles`` (..., S, D/2), in float32."""
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL M-RoPE.  x: (..., S, H, D); positions3: (..., S, 3) integer
    (t, h, w) position ids.  The D/2 frequency slots are split into
    ``sections`` (t | h | w, in that order); each slot takes its angle from
    its own position stream.  The rotate-half layout is ``apply_rope``'s;
    with t == h == w the two agree bit for bit."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to head_dim/2 "
                         f"= {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    # each slot's stream by slicing, not by an index tensor: no host copy,
    # so a CUDA graph can capture it
    pf = positions3.float()
    pos = torch.cat([pf[..., i:i + 1].expand(*pf.shape[:-1], n)
                     for i, n in enumerate(sections)], dim=-1)  # (..., S, d/2)
    return _rotate_half(x, pos * freqs)


def positions_for(cfg: ModelConfig, pos1d: torch.Tensor) -> torch.Tensor:
    """Model-facing positions from 1-D positions (the reference's
    ``serving/executor.py`` ``positions_for``): an M-RoPE config takes the
    (..., 3) layout with t = h = w = ``pos1d`` (a broadcast view), every
    other config ``pos1d`` itself.  The one definition that prefill, the
    decode and shadow steps, the EAT probe and the rollouts share, so cached
    and probed positions cannot drift apart."""
    if cfg.mrope_sections:
        return pos1d[..., None].expand(*pos1d.shape, 3)
    return pos1d


def maybe_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RoPE by the config: M-RoPE over (B, S, 3) positions where
    ``mrope_sections`` is set, else plain RoPE over (B, S) (the
    reference's ``_maybe_rope``)."""
    if cfg.mrope_sections:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


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
