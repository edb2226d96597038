"""The wide flash kernel (bf16 at head dim 256, Gemma's) on the card.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_wide_cuda.py

* ``flash_attention_cuda`` at (256, 256) in bf16 launches the wide kernel
  (``"wide"``) once and nothing else, and holds to its plain version within
  ``chip_smoke.py``'s bf16 flash bar (one ulp of the larger output + 2^-7 x
  the attention of |v|) over ragged cases: causal and sliding-window,
  left-padded rows (pad queries with no valid key give 0), g 1 and 8, Sq 1,
  17 and 512, key counts off the kernel's 32-key tile.
* Appending key slots at position -1 (random K and V) leaves its output
  bitwise unchanged: the paged == ring property of the serves.
* The C entry point refuses a pair it was not built for, and float32 at
  256 stays on the scalar kernel.  The scalar kernel forced at bf16 256
  (``chip_smoke.py``'s yardstick) launches it and holds the same bar.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa

pytestmark = pytest.mark.gpu

D = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the wide flash kernel needs the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, Sq, Skv, Hq, Hkv, layout, dtype=torch.bfloat16, extra=0, seed=0):
    """q (B, Sq, Hq, 256) against k/v (B, Skv + extra, Hkv, 256).
    ``leftpad`` (Sq == Skv): row b has 7 b pad slots, its pad queries at -1;
    ``end``: the Sq newest of row b's Skv - 5 b tokens, the rest empty.
    ``extra`` slots at position -1 (random K/V) are appended."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev).to(dtype)

    q, k, v = rnd(B, Sq, Hq, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, D)
    k = torch.cat([k, rnd(B, extra, Hkv, D)], 1)
    v = torch.cat([v, rnd(B, extra, Hkv, D)], 1)
    ar = torch.arange(Skv, device=dev, dtype=torch.int32)[None]
    rows = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    if layout == "leftpad":
        kv_pos = torch.where(ar >= 7 * rows, ar - 7 * rows, -1)
        q_pos = kv_pos
    else:
        n = Skv - 5 * rows
        kv_pos = torch.where(ar < n, ar, -1)
        q_pos = n - Sq + ar[:, :Sq]
    kv_pos = torch.cat([kv_pos, torch.full((B, extra), -1, device=dev,
                                           dtype=torch.int32)], 1)
    return (q, k, v, q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


def _within_bar(out, ref, q, k, v, q_pos, kv_pos, **kw):
    """One bf16 ulp of the larger output + 2^-7 x the attention of |v|."""
    diff = (out.float() - ref.float()).abs()
    spread = fa.attention_plain(q, k, v.abs(), q_pos, kv_pos, **kw).float()
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return bool((diff <= ulp + 2.0 ** -7 * spread).all())


# (B, Sq, Skv, Hq, Hkv, layout, window): gemma-7b's g 1 and gemma-2b's g 8,
# prefills (Sq == Skv, left-padded, 512 and off the tile), a decode (Sq 1)
# and chunks of 17 over caches off the 32-key tile, causal and windowed
CASES = [
    (2, 512, 512, 4, 4, "leftpad", 0),
    (2, 512, 512, 8, 1, "leftpad", 0),
    (2, 17, 75, 4, 4, "end", 0),
    (2, 17, 75, 8, 1, "end", 0),
    (3, 1, 131, 4, 4, "end", 0),
    (2, 1, 200, 8, 1, "end", 0),
    (2, 100, 100, 8, 1, "leftpad", 24),
    (2, 17, 150, 4, 4, "end", 40),
    (2, 512, 517, 2, 2, "end", 0),
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,layout,window", CASES,
                         ids=[f"B{a}-Sq{b}-Skv{c}-g{d // e}-{f}-w{g}"
                              for a, b, c, d, e, f, g in CASES])
def test_wide_kernel_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, layout, window):
    args = _case(cuda, B, Sq, Skv, Hq, Hkv, layout)
    kw = dict(window=window, scale=1.0 / math.sqrt(D))
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, **kw)
    after = fa.flash_attention_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {
        x: int(x == "wide") for x in after}
    ref = fa.attention_plain(*args, **kw)
    assert bool(torch.isfinite(out).all())
    assert _within_bar(out, ref, *args, **kw)
    if layout == "leftpad":          # pad queries see no key: exactly 0
        assert not bool(out[1, :7].any())


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,layout,window", CASES[:7],
                         ids=[f"B{a}-Sq{b}-Skv{c}-g{d // e}-{f}-w{g}"
                              for a, b, c, d, e, f, g in CASES[:7]])
def test_wide_kernel_ignores_trailing_masked_slots_bitwise(cuda, B, Sq, Skv, Hq,
                                                           Hkv, layout, window):
    kw = dict(window=window, scale=1.0 / math.sqrt(D))
    out = fa.flash_attention_cuda(*_case(cuda, B, Sq, Skv, Hq, Hkv, layout), **kw)
    for extra in (1, 64, 77):
        longer = fa.flash_attention_cuda(
            *_case(cuda, B, Sq, Skv, Hq, Hkv, layout, extra=extra), **kw)
        assert torch.equal(out, longer), extra


def test_float32_at_256_takes_the_scalar_kernel(cuda):
    args = _case(cuda, 2, 17, 75, 4, 4, "end", dtype=torch.float32)
    kw = dict(scale=1.0 / math.sqrt(D))
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, **kw)
    after = fa.flash_attention_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {
        x: int(x == "scalar") for x in after}
    assert (out - fa.attention_plain(*args, **kw)).abs().max().item() <= 1e-5


def test_forced_scalar_at_256_holds_the_bar(cuda):
    args = _case(cuda, 2, 17, 75, 8, 1, "end")
    kw = dict(scale=1.0 / math.sqrt(D))
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, variant="scalar", **kw)
    after = fa.flash_attention_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {
        x: int(x == "scalar") for x in after}
    assert _within_bar(out, fa.attention_plain(*args, **kw), *args, **kw)


@pytest.mark.parametrize("dk,dv", [(128, 128), (256, 128), (192, 192)])
def test_entry_point_refuses_pairs_it_was_not_built_for(cuda, dk, dv):
    """The C entry returns cudaErrorInvalidValue (1) for a pair outside
    ``WIDE_HEAD_DIMS``, before any launch: never re-routed."""
    lib = _build.load("flash_attention", fa._SIGNATURES)
    B, S, H = 1, 32, 2
    q = torch.zeros((B, S, H, dk), dtype=torch.bfloat16, device=cuda)
    v = torch.zeros((B, S, H, dv), dtype=torch.bfloat16, device=cuda)
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None].contiguous()
    out = torch.full((B, S, H, dv), 7.0, dtype=torch.bfloat16, device=cuda)
    err = lib.flash_attention_wide(
        _build.ptr(q), _build.ptr(q), _build.ptr(v), _build.ptr(pos), _build.ptr(pos),
        _build.ptr(out), B, S, S, H, H, dk, dv, 1, 0, ctypes.c_float(0.1),
        _build.stream_ptr(q))
    torch.cuda.synchronize()
    assert err == 1 and bool((out == 7.0).all())
    assert fa.flash_variant(torch.bfloat16, dk, dv) != "wide"
