"""Page-table-native decode attention (port of
``repro/kernels/paged_attention/ref.py``, ``ops.py`` and ``kernel.py``).

One accumulation contract, every impl: a per-page online softmax over the
row's pages in increasing logical order (the kernel folds splits of whole
logical blocks that way and merges them in order), where a fully masked
page is an exact identity step on (running max, sum, accumulator).  The
paged caller visits only the mapped pages; the ring caller
(``ring_decode_attention``) visits every logical block of its dense cache
through an identity page list.  Skipped pages being identity steps, the
two give bitwise equal results per impl — the contract the serving
stack's paged == ring A/B relies on.

* ``paged_attention_plain`` — the plain PyTorch version (the reference's
  ``paged_attention_xla`` / ``block_decode_attention``).
* ``paged_attention_cuda`` — the hand-written kernel
  (``csrc/paged_attention.cu``, replacing ``paged_attention_pallas``).  It
  splits the KV axis at logical-block boundaries (``split_plan``) and
  merges the splits in order; pages still fold in logical order inside a
  split, and each probability still rounds against the row's running max
  over every earlier page, so the two callers stay bitwise equal.
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
#: keys per split of the kernel's KV axis (whole logical blocks of them)
SPLIT_TOKENS = 64
#: the kernel's limits: keys per page, head dims
MAX_PAGE_SIZE = 64
MAX_HEAD_DIM = 256
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"paged_decode_attention": [_I] + [_P] * 13 + [_I] * 11 + [_F, _P]}


def split_plan(page_size: int, num_blocks: int) -> tuple[int, int]:
    """(K, n_split): the kernel's split s holds logical blocks
    [s·K, (s+1)·K), and n_split splits cover ``num_blocks`` logical blocks.

    K depends on the page size alone — never on which blocks are mapped,
    the bucket width or a rank — so the ring and paged calls of one cache
    put every logical block into the same split."""
    K = max(1, SPLIT_TOKENS // page_size)
    return K, -(-num_blocks // K)


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
                          scale: float, window: int = 0, logical=None,
                          num_blocks: int | None = None) -> torch.Tensor:
    """The block scan over every rank of ``pages`` (ranks past ``counts``
    read the trash page with every position masked: identity steps).  A
    sequential scan needs no split: ``logical`` and ``num_blocks`` are
    accepted for the kernel's signature and not read."""
    del counts, logical, num_blocks
    B, m, Hq, Dk = q.shape
    Hkv, Dv = k_pool.shape[2], v_pool.shape[-1]
    g = Hq // Hkv
    qs = q * torch.full((), scale, dtype=q.dtype, device=q.device)
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
                         scale: float, window: int = 0, logical=None,
                         num_blocks: int | None = None) -> torch.Tensor:
    """``logical`` (B, NBK) int32: the logical block of each rank;
    ``num_blocks``: the logical capacity of a row in blocks (every logical
    block index is below it).  Both fix the split and are required."""
    _build.no_autograd("paged_attention", q, k_pool, v_pool)
    if logical is None or num_blocks is None:
        raise ValueError("paged_attention_cuda needs logical (the logical "
                         "block of each rank) and num_blocks (the logical "
                         "capacity): the KV axis is split by logical block")
    B, m, Hq, Dk = q.shape
    P, ps, Hkv, _ = k_pool.shape
    Dv = v_pool.shape[-1]
    NBK = pages.shape[1]
    if Hq % Hkv or k_pool.shape[3] != Dk or v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k_pool{tuple(k_pool.shape)} v_pool{tuple(v_pool.shape)}")
    if (tuple(counts.shape) != (B,) or tuple(bpos.shape) != (B, NBK, ps)
            or tuple(q_pos.shape) != (B, m) or tuple(pages.shape) != (B, NBK)
            or tuple(logical.shape) != (B, NBK)):
        raise ValueError("paged_attention: bad page-list or position shapes")
    esize = q.element_size()
    if (ps > MAX_PAGE_SIZE or max(Dk, Dv) > MAX_HEAD_DIM
            or (Dk * esize) % 16 or (Dv * esize) % 16):
        raise ValueError(f"paged_attention kernel takes pages of <= "
                         f"{MAX_PAGE_SIZE} keys and head dims <= {MAX_HEAD_DIM} "
                         f"of a multiple of 16 bytes; got ps {ps}, Dk {Dk}, Dv {Dv}")
    q, q_pos = q.contiguous(), q_pos.contiguous()
    _build.expect(q, q.dtype, 4, "q")
    _build.expect(k_pool, q.dtype, 4, "k_pool")
    _build.expect(v_pool, q.dtype, 4, "v_pool")
    for x, name, nd in ((pages, "pages", 2), (logical, "logical", 2),
                        (counts, "counts", 1), (bpos, "bpos", 3),
                        (q_pos, "q_pos", 2)):
        _build.expect(x, torch.int32, nd, name)
    g = Hq // Hkv
    rows = m * g
    K, n_split = split_plan(ps, num_blocks)
    lib = _build.load("paged_attention", _SIGNATURES)
    # float32 scratch: per (b, h, split, row) the split's max, its (m, l),
    # its accumulator and the max pass's scores, in one allocation
    n = B * Hkv * n_split * rows
    scratch = torch.empty(n * (3 + Dv + K * ps), dtype=torch.float32,
                          device=q.device)
    split_max, part_ml, part_acc, scores = scratch.split(
        [n, 2 * n, n * Dv, n * K * ps])
    out = torch.empty((B, m, Hq, Dv), dtype=q.dtype, device=q.device)
    err = lib.paged_decode_attention(
        _build.dtype_code(q), _build.ptr(q), _build.ptr(k_pool),
        _build.ptr(v_pool), _build.ptr(pages), _build.ptr(logical),
        _build.ptr(counts), _build.ptr(bpos), _build.ptr(q_pos),
        _build.ptr(split_max), _build.ptr(part_ml), _build.ptr(part_acc),
        _build.ptr(scores), _build.ptr(out), B, Hkv, m, g, Dk, Dv, ps, NBK,
        K, n_split, int(window), float(scale), _build.stream_ptr(q))
    _build.check(err, "paged_decode_attention")
    paged_attention_cuda.launches += 1
    return out


#: op calls, counted in Python as each call launches: eager calls, and calls
#: recorded under a CUDA-graph capture.  A replay counts nothing here; the
#: chunk graphs (``serving/device_loop.ChunkGraphs``) take a capture's counts
#: back out and add them at each replay, so a serve counts what ran
paged_attention_cuda.launches = 0


def paged_decode_attention(q, k_pool, v_pool, pages, counts, bpos, q_pos, *,
                           window: int = 0, scale: float | None = None,
                           impl: str = "auto", logical=None,
                           num_blocks: int | None = None) -> torch.Tensor:
    """q (B, m, Hq, Dk); pools (P, ps, Hkv, D); pages (B, NBK), counts (B,),
    bpos (B, NBK, ps), q_pos (B, m) int32; logical (B, NBK) int32 and
    num_blocks (the logical capacity in blocks), which the kernel needs.
    Returns (B, m, Hq, Dv)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    fn = (paged_attention_cuda if _build.resolve_impl(impl, q) == "cuda"
          else paged_attention_plain)
    return fn(q, k_pool, v_pool, pages, counts, bpos, q_pos, scale=scale,
              window=window, logical=logical, num_blocks=num_blocks)


def ring_decode_attention(q, k, v, q_pos, kv_pos, *, page_size: int,
                          window: int = 0, scale: float | None = None,
                          impl: str = "auto") -> torch.Tensor:
    """The dense ring cache (B, C, Hkv, D) through the page algorithm: its
    rows become a (B * C/ps)-page pool read through the identity page list,
    every logical block mapped at its own rank (``logical`` = the ranks).  A
    capacity that is not a page multiple is padded with masked slots
    (appended identity steps)."""
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
    logical = ranks.expand(B, NB).contiguous()
    return paged_decode_attention(q, pool_k, pool_v, pages, counts, bpos,
                                  q_pos, window=window, scale=scale, impl=impl,
                                  logical=logical, num_blocks=NB)
