"""Fused EAT entropy probe (port of ``repro/kernels/entropy_probe/ops.py``
and ``kernel.py``): the Shannon entropy (nats) of softmax(h @ w)[:, :vocab]
per row, without materialising the (B, Vp) logits.

* ``next_token_entropy_plain`` — the plain PyTorch version (the
  reference's ``_xla_entropy``: running (m, Z, T) over vocab chunks).
* ``entropy_probe_cuda`` — the hand-written kernel
  (``csrc/entropy_probe.cu``, replacing ``entropy_probe_pallas``).
* ``next_token_entropy`` — the dispatcher (``impl="auto"``: kernel for CUDA
  tensors, plain version for CPU tensors).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_NEG_INF = -1e30
_BLOCK_V = 8192          # vocab columns per step of the plain version
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "entropy_probe": [_I, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _P],
    "entropy_tile_count": [_I],
}


def next_token_entropy_plain(h, w, vocab: int) -> torch.Tensor:
    B, _ = h.shape
    Vp = w.shape[1]
    hf = h.float()
    m = torch.full((B,), _NEG_INF, device=h.device)
    z = torch.zeros((B,), device=h.device)
    t = torch.zeros((B,), device=h.device)
    for j0 in range(0, Vp, _BLOCK_V):
        logits = hf @ w[:, j0:j0 + _BLOCK_V].float()
        col = torch.arange(j0, j0 + logits.shape[1], device=h.device)
        valid = col < vocab
        logits = torch.where(valid, logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        e = torch.where(valid, torch.exp(logits - m_new[:, None]), 0.0)
        z = z * alpha + e.sum(dim=-1)
        t = t * alpha + (e * torch.where(valid, logits, 0.0)).sum(dim=-1)
        m = m_new
    return m + torch.log(z) - t / z


def entropy_probe_cuda(h, w, vocab: int) -> torch.Tensor:
    """h (B, d) contiguous; w (d, Vp) of h's dtype, any strides (a tied
    config passes the transposed embedding view, read in place)."""
    _build.expect(h, h.dtype, 2, "h")
    if not w.is_cuda or w.dtype != h.dtype or w.dim() != 2:
        raise ValueError(f"w must be a 2-D CUDA tensor of {h.dtype}")
    B, d = h.shape
    if w.shape[0] != d or not 0 < vocab <= w.shape[1]:
        raise ValueError(f"shape mismatch h{tuple(h.shape)} w{tuple(w.shape)} "
                         f"vocab {vocab}")
    lib = _build.load("entropy_probe", _SIGNATURES)
    Vp = w.shape[1]
    part = torch.empty((lib.entropy_tile_count(Vp), B, 3), dtype=torch.float32,
                       device=h.device)
    out = torch.empty((B,), dtype=torch.float32, device=h.device)
    err = lib.entropy_probe(
        _build.dtype_code(h), _build.ptr(h), _build.ptr(w), _build.ptr(part),
        _build.ptr(out), B, d, Vp, w.stride(0), w.stride(1), int(vocab),
        _build.stream_ptr(h))
    _build.check(err, "entropy_probe")
    entropy_probe_cuda.launches += 1
    return out


entropy_probe_cuda.launches = 0


def next_token_entropy(h, w, vocab: int, *, impl: str = "auto") -> torch.Tensor:
    """h (B, d) final hidden states at the probe position; w (d, Vp)
    unembedding.  Returns (B,) float32 nats."""
    if _build.resolve_impl(impl, h) == "cuda":
        return entropy_probe_cuda(h, w, vocab)
    return next_token_entropy_plain(h, w, vocab)
