"""Fused EAT entropy probe (port of ``repro/kernels/entropy_probe/ops.py``
and ``kernel.py``): the Shannon entropy (nats) of softmax(h @ w)[:, :vocab]
per row, without materialising the (B, Vp) logits.

* ``next_token_entropy_plain`` — the plain PyTorch version (the
  reference's ``_xla_entropy``: running (m, Z, T) over vocab chunks), with
  T taken about the running max, T = sum exp(x - m) (x - m), and H = log Z
  - T / Z.  The reference's T is taken about 0 and its H = m + log Z - T / Z
  cancels where one token takes nearly all the mass: both terms near m, each
  rounded to an ulp of m (1.9e-6 at a logit of 27).  The kernels do the
  same (``csrc/entropy_probe.cu``).
* ``entropy_probe_cuda`` — the hand-written kernels
  (``csrc/entropy_probe.cu``, replacing ``entropy_probe_pallas``), two
  launches a call: a statistics kernel chosen by ``entropy_variant``, then
  the merge.  ``"mma"``: bf16 on the tensor cores, W streamed once through
  a ``cp.async`` ring by a grid of resident blocks, one (m, Z, T) partial
  per (block, row); ``"scalar"``: one thread per vocab column with float32
  FMAs, one partial per 256-column tile.  Neither keeps state between
  calls.
* ``next_token_entropy`` — the dispatcher (``impl="auto"``: kernel for CUDA
  tensors, plain version for CPU tensors).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_NEG_INF = -1e30
_BLOCK_V = 8192          # vocab columns per step of the plain version
#: vocab columns per tile of the scalar kernel (csrc TV) and of the tensor-
#: core kernel (csrc TVM); the mma kernel's k-step and its rows per group
SCALAR_TILE_V = 256
MMA_TILE_V = 128
MMA_K_STEP = 16
MMA_ROWS = 32
#: W's stride that is not 1 and d must be multiples of it, and h and W
#: 16-byte aligned: the tensor-core kernel copies 16 bytes at a time
MMA_ALIGN = 8
#: launches per op call of each variant (statistics kernel + merge)
KERNELS_PER_CALL = {"mma": 2, "scalar": 2}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "entropy_probe": [_I, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _P],
    "entropy_probe_mma": [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _P],
    "entropy_probe_occupancy": [_I, _I, ctypes.POINTER(ctypes.c_int)],
}
# per device: SM count; per (device, tied, B): resident blocks per SM of the
# tensor-core statistics kernel
_SM_COUNT: dict[int, int] = {}
_OCCUPANCY: dict[tuple, int] = {}


def mma_layout(w) -> str | None:
    """``"untied"`` for a (d, Vp) W with vocab contiguous (strides (sd, 1),
    sd a multiple of ``MMA_ALIGN``), ``"tied"`` for the transposed view of a
    (Vp, d) table (strides (1, sv), sv a multiple of it), else None."""
    sd, sv = w.stride()
    if sv == 1 and sd % MMA_ALIGN == 0:
        return "untied"
    if sd == 1 and sv % MMA_ALIGN == 0:
        return "tied"
    return None


def entropy_variant(h, w) -> str:
    """The statistics kernel ``entropy_probe_cuda`` launches: ``"mma"``
    (bf16 on the tensor cores) for bfloat16 h and W with W in one of the
    two layouts of ``mma_layout``, d a multiple of ``MMA_ALIGN`` (h's rows
    are copied 16 bytes at a time) and both data pointers 16-byte aligned;
    else ``"scalar"``.  float32 stays scalar: on the tensor cores it would
    run in TF32, short of the 1e-5 float32 bar."""
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or w.dim() != 2:
        return "scalar"
    if (w.shape[0] % MMA_ALIGN or mma_layout(w) is None or h.data_ptr() % 16
            or w.data_ptr() % 16):
        return "scalar"
    return "mma"


def mma_blocks(Vp: int, slots: int) -> int:
    """Blocks G of the tensor-core kernel's grid (its partials per row);
    block i takes tiles i, i + G, ... of ``MMA_TILE_V`` columns.  At most
    the card's resident blocks ``slots``, and as few as give every block
    the same number of tiles, give or take one: q = ceil(tiles / slots)
    tiles a block, ceil(tiles / q) blocks."""
    n_tiles = -(-Vp // MMA_TILE_V)
    q = -(-n_tiles // max(1, slots))
    return -(-n_tiles // q)


def _slots(lib, device, tied: bool, B: int) -> int:
    """Resident blocks of the tensor-core kernel on the whole card: the SM
    count times its blocks per SM at this layout and batch, each cached per
    device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    key = (idx, tied, B)
    if key not in _OCCUPANCY:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = lib.entropy_probe_occupancy(int(tied), B, ctypes.byref(blocks))
        _build.check(err, "entropy_probe occupancy")
        _OCCUPANCY[key] = max(1, blocks.value)
    return _SM_COUNT[idx] * _OCCUPANCY[key]


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
        t = (t + (m - m_new) * z) * alpha + (
            e * torch.where(valid, logits - m_new[:, None], 0.0)).sum(dim=-1)
        z = z * alpha + e.sum(dim=-1)
        m = m_new
    return torch.log(z) - t / z


def entropy_probe_cuda(h, w, vocab: int, *, variant=None) -> torch.Tensor:
    """h (B, d) contiguous; w (d, Vp) of h's dtype, any strides (a tied
    config passes the transposed embedding view, read in place).
    ``variant``: None for ``entropy_variant``'s choice, or ``"mma"`` /
    ``"scalar"`` to force one (the comparisons and timings of
    ``chip_smoke.py`` and the GPU tests)."""
    _build.no_autograd("entropy_probe", h, w)
    _build.expect(h, h.dtype, 2, "h")
    if not w.is_cuda or w.dtype != h.dtype or w.dim() != 2:
        raise ValueError(f"w must be a 2-D CUDA tensor of {h.dtype}")
    B, d = h.shape
    if w.shape[0] != d or not 0 < vocab <= w.shape[1]:
        raise ValueError(f"shape mismatch h{tuple(h.shape)} w{tuple(w.shape)} "
                         f"vocab {vocab}")
    variant = variant or entropy_variant(h, w)
    if variant not in KERNELS_PER_CALL:
        raise ValueError(f"unknown entropy_probe variant {variant!r}")
    if variant == "mma" and entropy_variant(h, w) != "mma":
        raise ValueError(
            "the mma variant needs bf16 h and w, w (d, Vp) with strides (sd, 1) "
            f"or (1, sv), sd or sv and d multiples of {MMA_ALIGN}, and h and w "
            f"16-byte aligned; got {h.dtype}, d {d}, strides {w.stride()}")
    lib = _build.load("entropy_probe", _SIGNATURES)
    Vp = w.shape[1]
    tied = variant == "mma" and mma_layout(w) == "tied"
    n_part = (mma_blocks(Vp, _slots(lib, h.device, tied, B)) if variant == "mma"
              else -(-Vp // SCALAR_TILE_V))
    part = torch.empty((n_part, B, 3), dtype=torch.float32, device=h.device)
    out = torch.empty((B,), dtype=torch.float32, device=h.device)
    if variant == "mma":
        err = lib.entropy_probe_mma(
            _build.ptr(h), _build.ptr(w), _build.ptr(part), _build.ptr(out), B,
            d, Vp, w.stride(1) if tied else w.stride(0), int(tied), int(vocab),
            n_part, _build.stream_ptr(h))
    else:
        err = lib.entropy_probe(
            _build.dtype_code(h), _build.ptr(h), _build.ptr(w), _build.ptr(part),
            _build.ptr(out), B, d, Vp, w.stride(0), w.stride(1), int(vocab),
            _build.stream_ptr(h))
    _build.check(err, f"entropy_probe ({variant})")
    entropy_probe_cuda.launches += 1
    entropy_probe_cuda.variant_launches[variant] += 1
    return out


#: op calls, counted in Python as each call launches: eager calls, and calls
#: recorded under a CUDA-graph capture.  A replay counts nothing here; the
#: chunk graphs (``serving/device_loop.ChunkGraphs``) take a capture's counts
#: back out and add them at each replay, so a serve counts what ran
entropy_probe_cuda.launches = 0
#: op calls per statistics kernel (``entropy_variant``), counted as
#: ``launches`` (eager calls and captures); they sum to ``launches``
entropy_probe_cuda.variant_launches = {"mma": 0, "scalar": 0}


def next_token_entropy(h, w, vocab: int, *, impl: str = "auto") -> torch.Tensor:
    """h (B, d) final hidden states at the probe position; w (d, Vp)
    unembedding.  Returns (B,) float32 nats."""
    if _build.resolve_impl(impl, h) == "cuda":
        return entropy_probe_cuda(h, w, vocab)
    return next_token_entropy_plain(h, w, vocab)
