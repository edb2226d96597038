"""Page-table-native decode attention (port of
``repro/kernels/paged_attention/ref.py``, ``ops.py`` and ``kernel.py``).

One algorithm, every impl: a sequential per-page online softmax over the
row's pages in increasing logical order, where a fully masked page is an
exact identity step on (running max, sum, accumulator).  The paged caller
visits only the mapped pages; the ring caller (``ring_decode_attention``)
visits every logical block of its dense cache through an identity page
list.  Skipped pages being identity steps, the two give bitwise equal
results per impl — the contract the serving stack's paged == ring A/B
relies on.

* ``paged_attention_plain`` — the plain PyTorch version (the reference's
  ``paged_attention_xla`` / ``block_decode_attention``).
* ``paged_attention_cuda`` — the hand-written kernel
  (``csrc/paged_attention.cu``, replacing ``paged_attention_pallas``).
* ``paged_decode_attention`` / ``ring_decode_attention`` — dispatchers:
  ``impl="auto"`` picks the kernel for CUDA tensors, the plain version for
  CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import (
    softmax_block_step,
    softmax_finish,
    softmax_init,
)

#: physical page id reserved as the trash page (serving.cache.PAGE_TRASH)
PAGE_TRASH = 0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"paged_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                          _P]}


def block_positions(kv_pos, pages, logical, page_size: int) -> torch.Tensor:
    """Per-rank slot positions from the logical ``pos`` array.

    kv_pos: (B, C); pages/logical: (B, NBK).  Rank ``j`` of row ``b`` holds
    logical block ``logical[b, j]``; ranks on the trash page are forced to
    -1 (fully masked), which makes padding ranks exact identity steps."""
    B, C = kv_pos.shape
    blocks = kv_pos.reshape(B, C // page_size, page_size)
    idx = logical.long()[:, :, None].expand(-1, -1, page_size)
    bpos = torch.gather(blocks, 1, idx)
    return torch.where((pages != PAGE_TRASH)[:, :, None], bpos,
                       torch.full_like(bpos, -1))


def paged_attention_plain(q, k_pool, v_pool, pages, counts, bpos, q_pos, *,
                          scale: float, window: int = 0) -> torch.Tensor:
    """The block scan over every rank of ``pages`` (ranks past ``counts``
    read the trash page with every position masked: identity steps)."""
    del counts  # padding ranks are identity steps; the scan visits them all
    B, m, Hq, Dk = q.shape
    Hkv, Dv = k_pool.shape[2], v_pool.shape[-1]
    g = Hq // Hkv
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    qf = qs.float().reshape(B, m, Hkv, g, Dk)
    qp = q_pos[:, None, None, :, None]
    carry = softmax_init(B, Hkv, g, m, Dv, q.device)
    pages = pages.long()
    for j in range(pages.shape[1]):
        carry = softmax_block_step(
            carry, qf, k_pool[pages[:, j]], v_pool[pages[:, j]], qp,
            bpos[:, j][:, None, None, None, :], causal=True, window=window)
    return softmax_finish(carry, q.dtype)


def paged_attention_cuda(q, k_pool, v_pool, pages, counts, bpos, q_pos, *,
                         scale: float, window: int = 0) -> torch.Tensor:
    B, m, Hq, Dk = q.shape
    P, ps, Hkv, _ = k_pool.shape
    Dv = v_pool.shape[-1]
    NBK = pages.shape[1]
    if Hq % Hkv or k_pool.shape[3] != Dk or v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k_pool{tuple(k_pool.shape)} v_pool{tuple(v_pool.shape)}")
    if (tuple(counts.shape) != (B,) or tuple(bpos.shape) != (B, NBK, ps)
            or tuple(q_pos.shape) != (B, m) or pages.shape[0] != B):
        raise ValueError("paged_attention: bad page-list or position shapes")
    g = Hq // Hkv
    rows = m * g
    # regroup q to (B, Hkv, m*g, Dk): row r = position r // g, head r % g
    qg = q.reshape(B, m, Hkv, g, Dk).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, rows, Dk).contiguous()
    qpg = q_pos[:, :, None].expand(B, m, g).reshape(B, rows).contiguous()
    _build.expect(qg, q.dtype, 4, "q")
    _build.expect(k_pool, q.dtype, 4, "k_pool")
    _build.expect(v_pool, q.dtype, 4, "v_pool")
    for x, name, nd in ((pages, "pages", 2), (counts, "counts", 1),
                        (bpos, "bpos", 3), (qpg, "q_pos", 2)):
        _build.expect(x, torch.int32, nd, name)
    lib = _build.load("paged_attention", _SIGNATURES)
    out = torch.empty((B, Hkv, rows, Dv), dtype=q.dtype, device=q.device)
    err = lib.paged_decode_attention(
        _build.dtype_code(q), _build.ptr(qg), _build.ptr(k_pool),
        _build.ptr(v_pool), _build.ptr(pages), _build.ptr(counts),
        _build.ptr(bpos), _build.ptr(qpg), _build.ptr(out),
        B, Hkv, rows, Dk, Dv, ps, NBK, int(window), float(scale),
        _build.stream_ptr(q))
    _build.check(err, "paged_decode_attention")
    paged_attention_cuda.launches += 1
    return out.reshape(B, Hkv, m, g, Dv).permute(0, 2, 1, 3, 4).reshape(
        B, m, Hq, Dv)


paged_attention_cuda.launches = 0


def paged_decode_attention(q, k_pool, v_pool, pages, counts, bpos, q_pos, *,
                           window: int = 0, scale: float | None = None,
                           impl: str = "auto") -> torch.Tensor:
    """q (B, m, Hq, Dk); pools (P, ps, Hkv, D); pages (B, NBK), counts (B,),
    bpos (B, NBK, ps), q_pos (B, m) int32.  Returns (B, m, Hq, Dv)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    fn = (paged_attention_cuda if _build.resolve_impl(impl, q) == "cuda"
          else paged_attention_plain)
    return fn(q, k_pool, v_pool, pages, counts, bpos, q_pos, scale=scale,
              window=window)


def ring_decode_attention(q, k, v, q_pos, kv_pos, *, page_size: int,
                          window: int = 0, scale: float | None = None,
                          impl: str = "auto") -> torch.Tensor:
    """The dense ring cache (B, C, Hkv, D) through the page algorithm: its
    rows become a (B * C/ps)-page pool read through the identity page list,
    every logical block mapped at its own rank.  A capacity that is not a
    page multiple is padded with masked slots (appended identity steps)."""
    B, C = kv_pos.shape
    pad = (-C) % page_size
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    NB = kv_pos.shape[1] // page_size
    bpos = kv_pos.reshape(B, NB, page_size)
    pool_k = k.reshape(B * NB, page_size, k.shape[2], k.shape[3])
    pool_v = v.reshape(B * NB, page_size, v.shape[2], v.shape[3])
    ranks = torch.arange(NB, dtype=torch.int32, device=q.device)
    pages = torch.arange(B, dtype=torch.int32, device=q.device)[:, None] * NB + ranks
    counts = torch.full((B,), NB, dtype=torch.int32, device=q.device)
    return paged_decode_attention(q, pool_k, pool_v, pages, counts, bpos,
                                  q_pos, window=window, scale=scale, impl=impl)
