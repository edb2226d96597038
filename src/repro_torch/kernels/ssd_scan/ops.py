"""Mamba2 SSD chunk scan (port of ``repro/kernels/ssd_scan/ops.py`` and
``kernel.py``, with the semantics of ``repro/models/ssm.py ssd_chunked``).

Per head, over chunks of ``chunk`` steps:

    h_t = exp(logd_t) h_{t-1} + B_t u_t^T        y_t = C_t . h_t

computed chunkwise as an intra-chunk term ((C B^T) * exp(segsum(logd))) U,
an inter-chunk term exp(cumsum(logd)) * (C h_prev) and the state update
h = exp(sum logd) h_prev + (exp(total - cumsum) * B)^T U.  ``h0`` is the
state before the first step (zeros when None).

* ``ssd_scan_plain`` — the plain PyTorch version (``ssd_chunked``, with a
  sequential loop over chunks in place of ``lax.associative_scan``).
* ``ssd_scan_cuda`` — the hand-written kernels (``csrc/ssd_scan.cu``,
  replacing ``ssd_scan_pallas``), which also take ``h0``.  ``ssd_variant``
  picks one by shape: ``"mma"``, the chunk-parallel tensor-core scan (three
  launches: the chunk states and C B^T per group; the pass over chunks;
  the outputs; every product 3xTF32), or ``"scalar"``, one block per
  (b, h) walking its chunks in order with float32 FMAs.  Neither keeps
  state between calls: calls on different streams may run at once.
* ``ssd_scan`` — the dispatcher: ``impl="auto"`` picks the kernel for CUDA
  tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: the kernel's limits (its register tiles and shared memory are sized for
#: at most 128 steps per chunk, 128 state rows and 64 head columns: every
#: SSM config of the repo)
MAX_CHUNK = MAX_STATE = 128
MAX_HEAD_DIM = 64
#: the tensor-core variant's tile unit: chunk, d_state and head_dim must be
#: multiples of it (mma.m16n8k8: k and n steps of 8)
MMA_ALIGN = 8
#: launches per op call of each variant
KERNELS_PER_CALL = {"mma": 3, "scalar": 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_scan": [_P] * 7 + [_I] * 7 + [_P],
               "ssd_scan_mma": [_P] * 10 + [_I] * 7 + [_P]}


def ssd_variant(chunk: int, d_state: int, head_dim: int) -> str:
    """The kernel a call takes, by shape alone: ``"mma"`` (tensor cores)
    where chunk, d_state and head_dim are multiples of ``MMA_ALIGN``, else
    ``"scalar"``."""
    if all(x % MMA_ALIGN == 0 for x in (chunk, d_state, head_dim)):
        return "mma"
    return "scalar"


def _segsum(cs: torch.Tensor) -> torch.Tensor:
    """cs (..., L) inclusive cumsum of logd -> (..., L, L) with
    M[t, s] = cs_t - cs_s for s <= t, -inf above the diagonal."""
    L = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=cs.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_scan_plain(u, logd, Bm, Cm, *, chunk: int, h0=None):
    Bsz, S, nh, hp = u.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = nh // G
    pad = (-S) % chunk
    if pad:                                  # logd = 0 pads are identities
        u = F.pad(u, (0, 0, 0, 0, 0, pad))
        logd = F.pad(logd, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    nc, L = Sp // chunk, chunk
    uc = u.reshape(Bsz, nc, L, nh, hp)
    dc = logd.reshape(Bsz, nc, L, nh)
    bc = Bm.reshape(Bsz, nc, L, G, N)
    cc = Cm.reshape(Bsz, nc, L, G, N)

    # one cumsum feeds every decay (the reference takes it twice, in
    # _segsum and here; once, the intra and inter terms round alike)
    cs = torch.cumsum(dc, dim=2)                               # (B,nc,L,nh)

    # intra-chunk (quadratic within the chunk)
    seg = _segsum(cs.movedim(-1, -2))                          # (B,nc,nh,L,L)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)
    cb = cb.repeat_interleave(rep, dim=2)                      # (B,nc,nh,L,L)
    y_intra = torch.einsum("bchls,bcshp->bclhp", cb * torch.exp(seg), uc)

    # per-chunk summary state: S_c = sum_s exp(l_last - l_s) B_s u_s
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    b_rep = bc.repeat_interleave(rep, dim=3)                   # (B,nc,L,nh,N)
    s_chunk = torch.einsum("bclhn,bclh,bclhp->bchnp", b_rep, decay_to_end, uc)

    # inter-chunk recurrence H_c = A_c H_{c-1} + S_c, in order
    a_chunk = torch.exp(cs[:, :, -1, :])                       # (B,nc,nh)
    h = (torch.zeros((Bsz, nh, N, hp), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = a_chunk[:, c, :, None, None] * h + s_chunk[:, c].float()
    h_before = torch.stack(h_before, dim=1)                    # (B,nc,nh,N,hp)

    # inter-chunk contribution: y_t += C_t . (exp(l_t) * H_before)
    c_rep = cc.repeat_interleave(rep, dim=3)
    y_inter = (torch.einsum("bclhn,bchnp->bclhp", c_rep, h_before)
               * torch.exp(cs)[..., None])
    y = (y_intra + y_inter).reshape(Bsz, Sp, nh, hp)[:, :S]
    return y.to(u.dtype), h


def ssd_scan_cuda(u, logd, Bm, Cm, *, chunk: int, h0=None, variant=None):
    """float32 in and out; every tensor contiguous, and for the mma
    variant 16-byte aligned (its copies move 16 bytes at a time).
    ``variant``: None for ``ssd_variant``'s choice, or ``"mma"`` /
    ``"scalar"`` to force one (the comparisons and timings of
    ``chip_smoke.py``)."""
    _build.no_autograd("ssd_scan", u, logd, Bm, Cm, h0)
    Bsz, S, nh, hp = u.shape
    G, N = Bm.shape[2], Bm.shape[3]
    for x, name, nd in ((u, "u", 4), (logd, "logd", 3), (Bm, "Bm", 4),
                        (Cm, "Cm", 4)):
        _build.expect(x, torch.float32, nd, name)
    if (tuple(logd.shape) != (Bsz, S, nh) or tuple(Bm.shape) != (Bsz, S, G, N)
            or Cm.shape != Bm.shape or nh % G):
        raise ValueError(f"shape mismatch u{tuple(u.shape)} logd{tuple(logd.shape)} "
                         f"Bm{tuple(Bm.shape)} Cm{tuple(Cm.shape)}")
    if not (0 < chunk <= MAX_CHUNK and N <= MAX_STATE and hp <= MAX_HEAD_DIM):
        raise ValueError(f"ssd_scan kernel takes chunk <= {MAX_CHUNK}, d_state "
                         f"<= {MAX_STATE}, head_dim <= {MAX_HEAD_DIM}; got "
                         f"{chunk}, {N}, {hp}")
    if h0 is not None:
        _build.expect(h0, torch.float32, 4, "h0")
        if tuple(h0.shape) != (Bsz, nh, N, hp):
            raise ValueError(f"h0 must be {(Bsz, nh, N, hp)}, got {tuple(h0.shape)}")
    variant = variant or ssd_variant(chunk, N, hp)
    if variant not in KERNELS_PER_CALL:
        raise ValueError(f"unknown ssd_scan variant {variant!r}")
    if variant == "mma" and ssd_variant(chunk, N, hp) != "mma":
        raise ValueError(f"the mma variant needs chunk, d_state and head_dim "
                         f"multiples of {MMA_ALIGN}; got {chunk}, {N}, {hp}")
    if variant == "mma":
        for x, name in ((u, "u"), (Bm, "Bm"), (Cm, "Cm"), (h0, "h0")):
            if x is not None and x.data_ptr() % 16:
                raise ValueError(f"the mma variant needs {name} 16-byte aligned")
    lib = _build.load("ssd_scan", _SIGNATURES)
    y = torch.empty_like(u)
    hf = torch.empty((Bsz, nh, N, hp), dtype=torch.float32, device=u.device)
    tensors = (_build.ptr(u), _build.ptr(logd), _build.ptr(Bm), _build.ptr(Cm),
               None if h0 is None else _build.ptr(h0), _build.ptr(y), _build.ptr(hf))
    dims = (Bsz, S, nh, hp, G, N, int(chunk), _build.stream_ptr(u))
    if variant == "mma":
        nc, Lp = -(-S // chunk), -(-chunk // 16) * 16
        f32 = dict(dtype=torch.float32, device=u.device)
        states = torch.empty((Bsz, nh, nc, N, hp), **f32)
        tot = torch.empty((Bsz, nh, nc), **f32)
        cb = torch.empty((Bsz, nc, G, Lp, Lp), **f32)
        err = lib.ssd_scan_mma(*tensors, _build.ptr(states), _build.ptr(tot),
                               _build.ptr(cb), *dims)
    else:
        err = lib.ssd_scan(*tensors, *dims)
    _build.check(err, f"ssd_scan ({variant})")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.variant_launches[variant] += 1
    return y, hf


#: op calls, counted in Python as each call launches: eager calls, and calls
#: recorded under a CUDA-graph capture.  A replay counts nothing here; the
#: chunk graphs (``serving/device_loop.ChunkGraphs``) take a capture's counts
#: back out and add them at each replay, so a serve counts what ran
ssd_scan_cuda.launches = 0
#: op calls per variant (``ssd_variant``), counted as ``launches`` (eager
#: calls and captures); they sum to ``launches``
ssd_scan_cuda.variant_launches = {"mma": 0, "scalar": 0}


def ssd_scan(u, logd, Bm, Cm, *, chunk: int, h0=None, impl: str = "auto"):
    """u (B, S, nh, hp), logd (B, S, nh), Bm/Cm (B, S, G, N), h0
    (B, nh, N, hp) or None.  Returns (y (B, S, nh, hp), h_final
    (B, nh, N, hp) float32)."""
    fn = ssd_scan_cuda if _build.resolve_impl(impl, u) == "cuda" else ssd_scan_plain
    return fn(u, logd, Bm, Cm, chunk=chunk, h0=h0)
