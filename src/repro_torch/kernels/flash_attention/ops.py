"""Masked GQA attention with explicit integer positions (port of
``repro/kernels/flash_attention/ops.py`` and ``kernel.py``).

* ``attention_plain`` — the plain PyTorch version: the reference's
  ``_xla_attention``, an online softmax over kv chunks (position < 0 is invalid,
  causal and sliding-window masks, GQA via ``h // g``, Dv may differ from
  Dk, 0 output where no key is valid; q scaled and the probabilities cast
  in the storage dtype before the two products, float32 statistics).
* ``flash_attention_cuda`` — the hand-written kernels
  (``csrc/flash_attention.cu``, replacing ``flash_attention_pallas``):
  the bf16 tensor-core kernel, the bf16 MLA kernel, the bf16 wide kernel
  (head dim 256) or the scalar kernel, by ``flash_variant``.
* ``attention`` — the dispatcher: ``impl="auto"`` picks the kernel for
  CUDA tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_NEG_INF = -1e30
# keys per step of the plain version; every caller uses this one size, which
# is what keeps its output bitwise independent of trailing masked slots
_KV_CHUNK = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention": [_I, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
               "flash_attention_mma": [_P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
               "flash_attention_wide": [_P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
               "flash_attention_mla": [_P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                       _P]}
#: (Dk, Dv) pairs the bf16 tensor-core kernel is instantiated for: the
#: port's configs (eat-paper-8b and qwen3-1.7b at 128, zamba2-2.7b's shared
#: block at 80: five k-steps, five pairs of output tiles) and its tests
MMA_HEAD_DIMS = frozenset({(16, 16), (32, 32), (64, 64), (80, 80), (128, 128),
                           (96, 64)})
#: (Dk, Dv) pairs the bf16 MLA kernel is instantiated for: MLA's absorbed
#: form, (kv_lora + rope, kv_lora), of deepseek-v2-236b (512 + 64) and of
#: its ``reduced()`` variant (32 + 16)
MLA_HEAD_DIMS = frozenset({(576, 512), (48, 32)})
#: (Dk, Dv) pairs the bf16 wide kernel is instantiated for: head dims past
#: the tensor-core kernel's 128, Gemma's 256 (gemma-2b, gemma-7b)
WIDE_HEAD_DIMS = frozenset({(256, 256)})
#: the MLA kernel's rows per block and keys per split (``csrc`` MLA_BM,
#: MLA_SPLIT_KEYS): a split is a fixed multiple of its 32-key tile, never
#: derived from the number of keys, so trailing empty splits leave the bits
MLA_ROWS = 64
MLA_SPLIT_KEYS = 64
#: the MLA kernel splits the keys when a call has fewer row tiles than this:
#: the H100's 132 SMs, one block each
MLA_SPLIT_BELOW = 132


def flash_variant(dtype, Dk: int, Dv: int) -> str:
    """Which kernel ``flash_attention_cuda`` launches: ``"mma"`` (bf16 on
    the tensor cores) for bfloat16 at a pair of ``MMA_HEAD_DIMS``,
    ``"mla"`` (bf16 on the tensor cores, every q head of a kv head in one
    tile, V read out of K) at a pair of ``MLA_HEAD_DIMS``, ``"wide"``
    (bf16 on the tensor cores, q staged in shared memory) at a pair of
    ``WIDE_HEAD_DIMS``, else ``"scalar"``.  float32 stays scalar: on the
    tensor cores it would run in TF32 (about 3 decimal digits), short of
    the 1e-5 float32 bar.  A bf16 head dim outside the three sets (the
    reference's 192, MLA's expanded 192/128) takes the scalar kernel too.  ``dtype`` is a torch dtype or a config's dtype name."""
    if str(dtype).removeprefix("torch.") != "bfloat16":
        return "scalar"
    for variant, pairs in (("mma", MMA_HEAD_DIMS), ("mla", MLA_HEAD_DIMS),
                           ("wide", WIDE_HEAD_DIMS)):
        if (Dk, Dv) in pairs:
            return variant
    return "scalar"


def mla_splits(B: int, Sq: int, Hq: int, Hkv: int, Skv: int) -> int:
    """The MLA kernel's key splits: 0 (one launch over every key) when the
    call has at least ``MLA_SPLIT_BELOW`` row tiles of ``MLA_ROWS`` (query
    position, q head) rows, else one split per ``MLA_SPLIT_KEYS`` keys and
    a merge.  Whether to split depends on B, Sq and the heads alone, so
    calls that differ only in trailing empty key slots (a paged view and a
    ring) split alike."""
    row_tiles = B * Hkv * -(-Sq * (Hq // Hkv) // MLA_ROWS)
    return 0 if row_tiles >= MLA_SPLIT_BELOW else -(-Skv // MLA_SPLIT_KEYS)


def softmax_block_step(carry, qf, kb, vb, qp, kp, *, causal: bool, window: int):
    """One block of the float32 online softmax shared by the plain
    versions of both attention kernels.

    carry = (m, l, acc) over (B, Hkv, g, Sq[, Dv]); qf (B, Sq, Hkv, g, Dk)
    float32, already scaled; kb/vb (B, blk, Hkv, D*) in the storage dtype;
    qp (B, 1, 1, Sq, 1) and kp (B, 1, 1, 1, blk) positions.  Masked
    probabilities are exactly 0, so a fully masked block returns the carry
    unchanged, bit for bit."""
    m_run, l_run, acc = carry
    s = _scores(qf, kb)
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & ((qp - kp) < window)
    s = torch.where(valid, s, _NEG_INF)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
    alpha = torch.exp(m_run - m_new)
    l_run = l_run * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
    return m_new, l_run, acc * alpha[..., None] + pv


def _scores(qf, kb):
    """The float32 scores (B, Hkv, g, Sq, blk), each one product over d.  A
    single query row per kv head (g = Sq = 1: multi-head attention at
    decode) gets a copied second row: for one row cuBLAS takes a GEMV,
    which sums d in another order than its GEMM kernels and the CUDA
    kernels (one FMA chain in ascending d) do, and a score summed in
    another order can round a bf16 probability the other way."""
    if qf.shape[1] * qf.shape[3] == 1:
        two = torch.cat([qf, qf], dim=1)
        return torch.einsum("bqhgd,bkhd->bhgqk", two, kb.float())[:, :, :, :1]
    return torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.float())


def softmax_init(B, Hkv, g, Sq, Dv, device):
    return (torch.full((B, Hkv, g, Sq), _NEG_INF, device=device),
            torch.zeros((B, Hkv, g, Sq), device=device),
            torch.zeros((B, Hkv, g, Sq, Dv), device=device))


def softmax_finish(carry, dtype):
    """(m, l, acc) -> (B, Sq, Hq, Dv): acc / l, 0 where no key was valid."""
    _, l_run, acc = carry
    B, Hkv, g, Sq, Dv = acc.shape
    l_run = l_run[..., None]
    out = torch.where(l_run > 0, acc / l_run.clamp_min(1e-30), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * g, Dv).to(dtype)


def attention_plain(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: int = 0, scale: float) -> torch.Tensor:
    """Online softmax over fixed ``_KV_CHUNK``-key blocks (the last one
    padded with masked slots).  Fixed blocks make the result independent of
    trailing masked slots: a ring cache larger than the prompt and a
    prompt-sized cache give bitwise equal outputs."""
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = Hq // Hkv
    qs = q * torch.full((), scale, dtype=q.dtype, device=q.device)
    qf = qs.float().reshape(B, Sq, Hkv, g, Dk)
    qp = q_pos[:, None, None, :, None]
    carry = softmax_init(B, Hkv, g, Sq, Dv, q.device)
    for j0 in range(0, Skv, _KV_CHUNK):
        kb, vb = k[:, j0:j0 + _KV_CHUNK], v[:, j0:j0 + _KV_CHUNK]
        kp = kv_pos[:, j0:j0 + _KV_CHUNK]
        pad = _KV_CHUNK - kb.shape[1]
        if pad:
            kb = F.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = F.pad(vb, (0, 0, 0, 0, 0, pad))
            kp = F.pad(kp, (0, pad), value=-1)
        carry = softmax_block_step(carry, qf, kb, vb, qp,
                                   kp[:, None, None, None, :],
                                   causal=causal, window=window)
    return softmax_finish(carry, q.dtype)


def is_k_prefix(v, k) -> bool:
    """Whether ``v`` is the view ``k[..., :Dv]``: the values of MLA's
    absorbed form, the latent c of k = cat(c, kr)."""
    return (v.dim() == k.dim() == 4 and v.shape[:3] == k.shape[:3]
            and v.shape[3] <= k.shape[3] and v.data_ptr() == k.data_ptr()
            and v.stride() == k.stride() and v.dtype == k.dtype)


def flash_attention_cuda(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                         window: int = 0, scale: float,
                         variant: str | None = None) -> torch.Tensor:
    """The kernel of ``flash_variant``, or with ``variant="scalar"`` the
    scalar kernel, which takes any pair (``chip_smoke.py`` times it beside
    the tensor-core kernels).  The MLA kernel reads V out of K's tile: it
    takes v only as the view ``k[..., :Dv]`` and raises otherwise.  The
    other kernels read a dense v: a strided v (that view, in float32) is
    copied first."""
    _build.no_autograd("flash_attention", q, k, v)
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if variant not in (None, "scalar"):
        raise ValueError(f"flash_attention: only the scalar kernel may be forced, "
                         f"not {variant!r}")
    variant = variant or flash_variant(q.dtype, Dk, Dv)
    if variant == "mla":
        if not is_k_prefix(v, k):
            raise ValueError("flash_attention (mla): v must be the view "
                             "k[..., :Dv]; the kernel reads V out of K's tile")
    elif not v.is_contiguous():
        v = v.contiguous()
    for x, name in ((q, "q"), (k, "k")):
        _build.expect(x, q.dtype, 4, name)
    if variant != "mla":
        _build.expect(v, q.dtype, 4, "v")
    _build.expect(q_pos, torch.int32, 2, "q_pos")
    _build.expect(kv_pos, torch.int32, 2, "kv_pos")
    if (k.shape[0], k.shape[3]) != (B, Dk) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if Hq % Hkv or tuple(q_pos.shape) != (B, Sq) or tuple(kv_pos.shape) != (B, Skv):
        raise ValueError("flash_attention: bad heads or position shapes")
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    if variant == "mla":
        for x, name in ((q, "q"), (k, "k")):
            if x.data_ptr() % 16:
                raise ValueError(f"flash_attention (mla): {name} must be "
                                 "16-byte aligned")
        n_split = mla_splits(B, Sq, Hq, Hkv, Skv)
        rows = n_split * B * Sq * Hq
        part_ml = torch.empty((rows * 2,), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((rows * Dv,), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_mla(
            _build.ptr(q), _build.ptr(k), _build.ptr(q_pos), _build.ptr(kv_pos),
            _build.ptr(out), _build.ptr(part_ml), _build.ptr(part_acc), B, Sq,
            Skv, Hq, Hkv, Dk, Dv, int(causal), int(window), float(scale),
            n_split, _build.stream_ptr(q))
        return _launched(err, variant, out)
    tensors = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(q_pos),
               _build.ptr(kv_pos), _build.ptr(out))
    dims = (B, Sq, Skv, Hq, Hkv, Dk, Dv, int(causal), int(window), float(scale),
            _build.stream_ptr(q))
    if variant in ("mma", "wide"):
        # their copies move 16 bytes at a time
        for x, name in ((q, "q"), (k, "k"), (v, "v")):
            if x.data_ptr() % 16:
                raise ValueError(f"flash_attention ({variant}): {name} must be "
                                 "16-byte aligned")
        err = getattr(lib, f"flash_attention_{variant}")(*tensors, *dims)
    else:
        err = lib.flash_attention(_build.dtype_code(q), *tensors, *dims)
    return _launched(err, variant, out)


def _launched(err: int, variant: str, out):
    _build.check(err, f"flash_attention ({variant})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[variant] += 1
    return out


#: op calls, counted in Python as each call launches: eager calls, and calls
#: recorded under a CUDA-graph capture.  A replay counts nothing here; the
#: chunk graphs (``serving/device_loop.ChunkGraphs``) take a capture's counts
#: back out and add them at each replay, so a serve counts what ran
flash_attention_cuda.launches = 0
#: launches per kernel (``flash_variant``), counted as ``launches`` (eager
#: calls and captures); they sum to ``launches``
flash_attention_cuda.variant_launches = {"mma": 0, "mla": 0, "wide": 0, "scalar": 0}


def attention(q, k, v, q_pos, kv_pos, *, causal: bool = True, window: int = 0,
              scale: float | None = None, impl: str = "auto") -> torch.Tensor:
    """q: (B, Sq, Hq, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv);
    q_pos: (B, Sq), kv_pos: (B, Skv) int32 (negative = invalid slot).
    Returns (B, Sq, Hq, Dv) in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _build.resolve_impl(impl, q) == "cuda":
        return flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal,
                                    window=window, scale=scale)
    return attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                           window=window, scale=scale)
