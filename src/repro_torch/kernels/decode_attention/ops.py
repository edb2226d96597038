"""Flash-decode attention over a dense KV cache (port of
``repro/kernels/decode_attention/ops.py`` and ``kernel.py``).

The m <= 8 new query positions of every GQA group attend causally (with an
optional sliding window) over a dense (B, C, Hkv, D) cache; the mask is
decided by the slot positions alone, so slot order is irrelevant (ring
caches).  Semantics are ``attention(causal=True)``.

* ``decode_attention_plain`` — the plain PyTorch version.  It follows the
  TPU kernel's arithmetic rather than the XLA path's: q cast to float32
  and then scaled, K and V in float32, probabilities kept in float32
  through P·V, an online softmax over fixed kv blocks with the -1e30
  sentinel, and 0 where no key is valid.  The CUDA kernel then differs
  from it by summation order only.
* ``decode_attention_cuda`` — the hand-written kernel
  (``csrc/decode_attention.cu``, replacing ``decode_attention_pallas``): a
  split-KV flash-decode with a deterministic merge of the splits.
* ``decode_attention`` — the dispatcher: ``impl="auto"`` picks the kernel
  for CUDA tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import (
    softmax_block_step,
    softmax_finish,
    softmax_init,
)

# keys per step of the plain version: the TPU kernel's default kv tile
_BLOCK_KV = 512
# the kernel's limits: head dims, and query rows (m * g) per kv head
MAX_HEAD_DIM = 128
MAX_ROWS = 64
# keys per shared-memory tile of the kernel (csrc/decode_attention.cu TILE)
_TILE = 64
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                    _P]}


def decode_attention_plain(q, k, v, q_pos, kv_pos, *, window: int = 0,
                           scale: float) -> torch.Tensor:
    B, m, Hq, Dk = q.shape
    C, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = Hq // Hkv
    qf = (q.float() * scale).reshape(B, m, Hkv, g, Dk)
    qp = q_pos[:, None, None, :, None]
    carry = softmax_init(B, Hkv, g, m, Dv, q.device)
    for j0 in range(0, C, _BLOCK_KV):
        # float32 blocks: the shared step's probability cast is then a no-op
        carry = softmax_block_step(
            carry, qf, k[:, j0:j0 + _BLOCK_KV].float(),
            v[:, j0:j0 + _BLOCK_KV].float(), qp,
            kv_pos[:, j0:j0 + _BLOCK_KV][:, None, None, None, :],
            causal=True, window=window)
    return softmax_finish(carry, q.dtype)


def split_plan(C: int, bh: int, n_sm: int) -> tuple[int, int]:
    """(n_split, keys per split): whole kernel tiles per split, and enough
    splits that the (B·Hkv, n_split) grid covers the SMs at least twice
    where the cache has that many tiles."""
    n_tiles = -(-C // _TILE)
    target = min(n_tiles, -(-2 * n_sm // bh))
    split_len = (n_tiles // target) * _TILE
    return -(-C // split_len), split_len


def decode_attention_cuda(q, k, v, q_pos, kv_pos, *, window: int = 0,
                          scale: float) -> torch.Tensor:
    B, m, Hq, Dk = q.shape
    C, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    code = _build.dtype_code(q)
    _build.expect(k, q.dtype, 4, "k")
    _build.expect(v, q.dtype, 4, "v")
    _build.expect(kv_pos, torch.int32, 2, "kv_pos")
    if not q.is_cuda or q_pos.dtype != torch.int32:
        raise TypeError("q must be a CUDA tensor and q_pos int32")
    if (k.shape[0], k.shape[3]) != (B, Dk) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if tuple(q_pos.shape) != (B, m) or tuple(kv_pos.shape) != (B, C):
        raise ValueError("decode_attention: bad position shapes")
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {Hkv}")
    g = Hq // Hkv
    rows = m * g
    if Dk > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM or rows > MAX_ROWS:
        raise ValueError(f"decode_attention kernel takes head dims <= "
                         f"{MAX_HEAD_DIM} and m*g <= {MAX_ROWS} rows; got Dk "
                         f"{Dk}, Dv {Dv}, m*g {rows}")
    # regroup q to (B, Hkv, m*g, Dk): row r = position r // g, head r % g
    qg = q.reshape(B, m, Hkv, g, Dk).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, rows, Dk).contiguous()
    qpg = q_pos[:, :, None].expand(B, m, g).reshape(B, rows).contiguous()
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split, split_len = split_plan(C, B * Hkv, n_sm)
    lib = _build.load("decode_attention", _SIGNATURES)
    part_ml = torch.empty((B * Hkv, n_split, rows, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B * Hkv, n_split, rows, Dv), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((B, Hkv, rows, Dv), dtype=q.dtype, device=q.device)
    err = lib.decode_attention(
        code, _build.ptr(qg), _build.ptr(k), _build.ptr(v),
        _build.ptr(qpg), _build.ptr(kv_pos), _build.ptr(part_ml),
        _build.ptr(part_acc), _build.ptr(out), B, Hkv, C, rows, Dk, Dv,
        n_split, split_len, int(window), float(scale), _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out.reshape(B, Hkv, m, g, Dv).permute(0, 2, 1, 3, 4).reshape(
        B, m, Hq, Dv)


decode_attention_cuda.launches = 0


def decode_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                     scale: float | None = None,
                     impl: str = "auto") -> torch.Tensor:
    """q (B, m, Hq, Dk); k (B, C, Hkv, Dk); v (B, C, Hkv, Dv); q_pos (B, m),
    kv_pos (B, C) int32 (negative = empty slot).  Returns (B, m, Hq, Dv) in
    q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    fn = (decode_attention_cuda if _build.resolve_impl(impl, q) == "cuda"
          else decode_attention_plain)
    return fn(q, k, v, q_pos, kv_pos, window=window, scale=scale)
