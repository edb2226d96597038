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
  sentinel, and 0 where no key is valid.  The scalar CUDA kernel differs
  from it by summation order only; the tensor-core kernel also scales the
  float32 score rather than q, and carries each probability as two bf16
  parts (hi + lo, a residual under 2^-17 of p) into P·V.
* ``decode_attention_cuda`` — the hand-written kernels
  (``csrc/decode_attention.cu``, replacing ``decode_attention_pallas``): a
  split-KV flash-decode with a deterministic merge of the splits, its split
  kernel chosen by ``decode_variant`` (the bf16 tensor-core kernel or the
  scalar one).  A call is two launches and copies nothing: the kernels read
  q and write the output in their (B, m, Hq, D) layout.
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
# the kernel's limits: head dims (Gemma's 256: past 128 the scalar kernel's
# K and V tiles share a buffer), and query rows (m * g) per kv head
MAX_HEAD_DIM = 256
MAX_ROWS = 64
# keys per shared-memory tile of the kernels (csrc/decode_attention.cu TILE)
_TILE = 64
# splits per (b, h) at most: the merge stages every split's (m, l) per row
# in shared memory
MAX_SPLIT = 64
#: (Dk, Dv) pairs the bf16 tensor-core kernel is instantiated for (the
#: REPRO_DECODE_MMA_CASE lines of the source): eat-paper-8b's and
#: qwen3-1.7b's 128, and the GPU tests' (64, 32) and (96, 64)
MMA_HEAD_DIMS = frozenset({(128, 128), (64, 32), (96, 64)})
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "decode_attention": [_I] + [_P] * 8 + [_I] * 10 + [_F, _P],
    "decode_attention_mma": [_P] * 8 + [_I] * 10 + [_F, _P],
    "decode_attention_occupancy": [_I] * 5 + [ctypes.POINTER(ctypes.c_int)],
}
# per device: SM count; per (device, variant, dtype, Dk, Dv, rows): resident
# blocks per SM of the split kernel
_SM_COUNT: dict[int, int] = {}
_OCCUPANCY: dict[tuple, int] = {}


def decode_variant(dtype, Dk: int, Dv: int) -> str:
    """Which split kernel ``decode_attention_cuda`` launches: ``"mma"`` (bf16
    on the tensor cores) for bfloat16 at a pair of ``MMA_HEAD_DIMS``, else
    ``"scalar"``.  float32 stays scalar: on the tensor cores it would run
    in TF32, short of the 1e-5 float32 bar.  ``dtype`` is a torch dtype or
    a config's dtype name."""
    name = str(dtype).removeprefix("torch.")
    return "mma" if name == "bfloat16" and (Dk, Dv) in MMA_HEAD_DIMS else "scalar"


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


def split_plan(C: int, bh: int, slots: int) -> tuple[int, int]:
    """(n_split, keys per split): whole kernel tiles per split, and as many
    splits (at most ``MAX_SPLIT``, at most one per tile) as fit the
    (B·Hkv, n_split) grid into ``slots`` resident blocks -- the SMs times
    the split kernel's blocks per SM -- so that the grid runs in one wave
    where the cache has the tiles for it.  One split when B·Hkv alone
    fills the slots."""
    n_tiles = -(-C // _TILE)
    target = max(1, min(n_tiles, MAX_SPLIT, slots // bh))
    split_len = -(-n_tiles // target) * _TILE
    return -(-C // split_len), split_len


def _slots(lib, device, variant: str, code: int, Dk: int, Dv: int,
           rows: int) -> int:
    """Resident blocks of the split kernel on the whole card: the SM count
    times its blocks per SM at this shape, each cached per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    key = (idx, variant, code, Dk, Dv, rows)
    if key not in _OCCUPANCY:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = lib.decode_attention_occupancy(int(variant == "mma"), code, Dk,
                                                 Dv, rows, ctypes.byref(blocks))
        _build.check(err, "decode_attention occupancy")
        _OCCUPANCY[key] = max(1, blocks.value)
    return _SM_COUNT[idx] * _OCCUPANCY[key]


def decode_attention_cuda(q, k, v, q_pos, kv_pos, *, window: int = 0,
                          scale: float) -> torch.Tensor:
    _build.no_autograd("decode_attention", q, k, v)
    B, m, Hq, Dk = q.shape
    C, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    code = _build.dtype_code(q)
    _build.expect(q, q.dtype, 4, "q")
    _build.expect(k, q.dtype, 4, "k")
    _build.expect(v, q.dtype, 4, "v")
    _build.expect(q_pos, torch.int32, 2, "q_pos")
    _build.expect(kv_pos, torch.int32, 2, "kv_pos")
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
    variant = decode_variant(q.dtype, Dk, Dv)
    if variant == "mma":
        # its copies move 16 bytes at a time
        for x, name in ((q, "q"), (k, "k"), (v, "v")):
            if x.data_ptr() % 16:
                raise ValueError(f"decode_attention (mma): {name} must be "
                                 "16-byte aligned")
    lib = _build.load("decode_attention", _SIGNATURES)
    n_split, split_len = split_plan(
        C, B * Hkv, _slots(lib, q.device, variant, code, Dk, Dv, rows))
    decode_attention_cuda.last_split = (n_split, split_len)
    part_ml = torch.empty((B * Hkv, n_split, rows, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B * Hkv, n_split, rows, Dv), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((B, m, Hq, Dv), dtype=q.dtype, device=q.device)
    tensors = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(q_pos),
               _build.ptr(kv_pos), _build.ptr(part_ml), _build.ptr(part_acc),
               _build.ptr(out))
    dims = (B, Hkv, C, m, g, Dk, Dv, n_split, split_len, int(window),
            float(scale), _build.stream_ptr(q))
    if variant == "mma":
        err = lib.decode_attention_mma(*tensors, *dims)
    else:
        err = lib.decode_attention(code, *tensors, *dims)
    _build.check(err, f"decode_attention ({variant})")
    decode_attention_cuda.launches += 1
    decode_attention_cuda.variant_launches[variant] += 1
    return out


#: op calls, counted in Python as each call launches: eager calls, and calls
#: recorded under a CUDA-graph capture.  A replay counts nothing here; the
#: chunk graphs (``serving/device_loop.ChunkGraphs``) take a capture's counts
#: back out and add them at each replay, so a serve counts what ran
decode_attention_cuda.launches = 0
#: (n_split, keys per split) of the latest call
decode_attention_cuda.last_split = None
#: launches per split kernel (``decode_variant``), counted as ``launches``
#: (eager calls and captures); they sum to ``launches``
decode_attention_cuda.variant_launches = {"mma": 0, "scalar": 0}


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
