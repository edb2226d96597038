"""Token sampling (temperature / top-k / top-p / typical-p / min-p),
padded-vocab aware (port of ``repro/serving/sampler.py``).

Greedy decoding matches the reference exactly; a categorical draw uses an
explicit ``torch.Generator`` and cannot reproduce JAX's random bits (the
filters are tested through their masks instead).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.6
    top_p: float = 0.95
    top_k: int = 0            # keep the k highest-prob tokens (0 = off)
    typical_p: float = 1.0    # keep the most locally-typical mass (1 = off)
    min_p: float = 0.0        # drop tokens with p < min_p * max_p (0 = off)
    greedy: bool = False


def _mask_padded(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    Vp = logits.shape[-1]
    if vocab < Vp:
        col = torch.arange(Vp, device=logits.device)
        logits = torch.where(col < vocab, logits, -torch.inf)
    return logits


def _take(x, idx):
    return torch.gather(x, -1, idx)


def filter_logits(lf: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """Apply the top-k / top-p / typical-p / min-p cutoffs as -inf masks
    (lf: (B, Vp) float32, temperature already applied).  Each filter keeps
    at least one token, as in the reference."""
    if 0 < cfg.top_k < lf.shape[-1]:
        kth = torch.topk(lf, cfg.top_k, dim=-1).values[:, -1:]
        lf = torch.where(lf >= kth, lf, -torch.inf)
    if cfg.top_p < 1.0:
        probs = torch.softmax(lf, dim=-1)
        srt = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(srt, dim=-1)
        idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff = _take(srt, idx.clamp_max(lf.shape[-1] - 1))
        lf = torch.where(probs >= cutoff, lf, -torch.inf)
    if cfg.typical_p < 1.0:
        logp = torch.log_softmax(lf, dim=-1)
        probs = torch.exp(logp)
        ent = -torch.where(probs > 0, probs * logp, 0.0).sum(dim=-1, keepdim=True)
        score = torch.abs(-logp - ent)
        order = torch.argsort(score, dim=-1, stable=True)
        cum = torch.cumsum(_take(probs, order), dim=-1)
        idx = (cum < cfg.typical_p).sum(dim=-1, keepdim=True)
        cutoff = _take(_take(score, order), idx.clamp_max(lf.shape[-1] - 1))
        lf = torch.where(score <= cutoff, lf, -torch.inf)
    if cfg.min_p > 0.0:
        probs = torch.softmax(lf, dim=-1)
        cutoff = cfg.min_p * probs.amax(dim=-1, keepdim=True)
        lf = torch.where(probs >= cutoff, lf, -torch.inf)
    return lf


def sample(logits: torch.Tensor, vocab: int, cfg: SamplerConfig = SamplerConfig(),
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits (B, Vp) -> (B,) int64 token ids."""
    lf = _mask_padded(logits.float(), vocab)
    if cfg.greedy:
        return torch.argmax(lf, dim=-1)
    lf = lf / max(cfg.temperature, 1e-6)
    lf = filter_logits(lf, cfg)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def logprob_of(logits: torch.Tensor, token: torch.Tensor, vocab: int) -> torch.Tensor:
    """log p(token) under softmax(logits[:, :vocab]).  logits (B,Vp), token (B,)."""
    lf = _mask_padded(logits.float(), vocab)
    logp = torch.log_softmax(lf, dim=-1)
    return torch.gather(logp, -1, token[:, None].long())[:, 0]
