"""The bf16 tensor-core flash-decode kernel's design, on the CPU.

The kernel (``decode_mma_kernel`` in ``csrc/decode_attention.cu``) runs only
on the card (``tests/test_torch_cuda.py``, marker ``gpu``).  Here its
arithmetic is emulated in torch float32 and held to ``decode_attention_plain``
at the bar ``chip_smoke.py`` holds the kernel to: one bf16 ulp of the larger
output plus 1e-6 (``DECODE_BF16_ATOL``).  The emulation follows the kernel:
bf16 q·k summed in float32 and then scaled; splits of whole 64-key tiles;
in each tile, each warp's key group runs its own online softmax; P enters
P·V as two bf16 parts (hi = bf16(p), lo = bf16(p - hi)); key groups merge in
order, then splits in order.  One bf16 rounding of P instead misses the bar,
which is why the kernel splits it.  Also here: ``decode_variant``'s rule,
the instantiated pairs against the source, and CPU tensors taking the plain
version without counting a launch.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da

CU = Path(da.__file__).resolve().parents[2] / "csrc" / "decode_attention.cu"
NEG_INF = -1e30
ATOL = 1e-6  # chip_smoke.py DECODE_BF16_ATOL


def _case(B, m, C, Hq, Hkv, D, seed=0):
    """bf16 inputs from numpy: a ring-rotated cache, ~10% of its slots
    empty, the m queries at the end of each row."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16)  # noqa: E731
    q = bf(rng.normal(size=(B, m, Hq, D)))
    k = bf(rng.normal(size=(B, C, Hkv, D)))
    v = bf(rng.normal(size=(B, C, Hkv, D)))
    kv_pos = np.full((B, C), -1, np.int32)
    q_pos = np.zeros((B, m), np.int32)
    for b in range(B):
        n = C - C // 10 - b
        kv_pos[b, (int(rng.integers(C)) + np.arange(n)) % C] = np.arange(n)
        q_pos[b] = np.arange(n - m, n)
    return q, k, v, torch.as_tensor(q_pos), torch.as_tensor(kv_pos)


def _merge(parts):
    """(m, l, acc) partials merged in order against their largest m."""
    M = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m_j, l_j, acc_j in parts:
        w = torch.exp(m_j - M)
        l = l + w * l_j
        acc = acc + w[..., None] * acc_j
    return M, l, acc


def _emulate(q, k, v, q_pos, kv_pos, *, window, scale, split_len, split_p=True):
    B, m, Hq, Dk = q.shape
    C, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = Hq // Hkv
    rows = m * g
    key_groups = {1: 4, 2: 2}.get(-(-rows // 16), 1)  # csrc key_groups()
    kw = da._TILE // key_groups
    qf = q.float().reshape(B, m, Hkv, g, Dk).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, rows, Dk)
    qp = q_pos[:, :, None].expand(B, m, g).reshape(B, 1, rows, 1)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    splits = []
    for s0 in range(0, C, split_len):
        groups = []
        for kg in range(key_groups):
            M = torch.full((B, Hkv, rows), NEG_INF)
            l = torch.zeros((B, Hkv, rows))
            acc = torch.zeros((B, Hkv, rows, Dv))
            for t0 in range(s0, min(C, s0 + split_len), da._TILE):
                a, b = t0 + kg * kw, min(C, t0 + (kg + 1) * kw)
                if a >= b:
                    continue
                kp = kv_pos[:, None, None, a:b]
                valid = (kp >= 0) & (kp <= qp)
                if window:
                    valid &= (qp - kp) < window
                s = torch.einsum("bhrd,bhkd->bhrk", qf, kf[:, :, a:b]) * scale
                s = torch.where(valid, s, NEG_INF)
                m_new = torch.maximum(M, s.amax(-1))
                p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
                alpha = torch.exp(M - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None]
                hi = p.to(torch.bfloat16).float()
                acc = acc + hi @ vf[:, :, a:b]
                if split_p:
                    lo = (p - hi).to(torch.bfloat16).float()
                    acc = acc + lo @ vf[:, :, a:b]
                M = m_new
            groups.append((M, l, acc))
        splits.append(_merge(groups))
    _, l, acc = _merge(splits)
    out = torch.where(l[..., None] > 0, acc / l[..., None].clamp_min(1e-30), 0.0)
    return out.reshape(B, Hkv, m, g, Dv).permute(0, 2, 1, 3, 4).reshape(
        B, m, Hq, Dv).to(q.dtype)


def _bar_ratio(out, ref):
    """Largest |out - ref| over (one bf16 ulp of the larger value + 1e-6),
    and how many elements exceed it."""
    diff = (out.float() - ref.float()).abs()
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    r = diff / (ulp + ATOL)
    return r.max().item(), int((r > 1).sum())


@pytest.mark.parametrize("B,m,C,Hq,Hkv,D,window", [
    (2, 1, 1500, 16, 4, 128, 0),     # 4 rows: four key groups of 16 keys
    (2, 2, 1500, 8, 2, 64, 0),
    (2, 5, 700, 16, 4, 64, 0),       # 20 rows: two m-tiles, two key groups
    (1, 8, 700, 64, 8, 32, 0),       # 64 rows: one warp per m-tile
    (2, 1, 1500, 16, 4, 128, 300),   # a window: most tiles skipped
])
def test_emulated_kernel_arithmetic_holds_the_bar(B, m, C, Hq, Hkv, D, window):
    args = _case(B, m, C, Hq, Hkv, D)
    scale = D ** -0.5
    ref = da.decode_attention_plain(*args, window=window, scale=scale)
    n_split, split_len = da.split_plan(C, B * Hkv, 264)
    assert n_split > 1
    out = _emulate(*args, window=window, scale=scale, split_len=split_len)
    ratio, over = _bar_ratio(out, ref)
    assert over == 0 and ratio <= 1, (ratio, over)


def test_one_bf16_rounding_of_p_misses_the_bar():
    """P rounded once to bf16 (as flash prefill's P·V does) moves outputs
    near zero by many times the bar: the reason for the hi + lo split."""
    args = _case(2, 2, 1500, 8, 2, 64)
    scale = 64 ** -0.5
    ref = da.decode_attention_plain(*args, scale=scale, window=0)
    _, split_len = da.split_plan(1500, 4, 264)
    split = _emulate(*args, window=0, scale=scale, split_len=split_len)
    single = _emulate(*args, window=0, scale=scale, split_len=split_len,
                      split_p=False)
    r_split, over_split = _bar_ratio(split, ref)
    r_single, over_single = _bar_ratio(single, ref)
    assert over_split == 0
    assert r_single > 5 and over_single > 10, (r_single, over_single)


@pytest.mark.parametrize("dtype,dk,dv,want", [
    (torch.bfloat16, 128, 128, "mma"),
    (torch.bfloat16, 64, 32, "mma"),
    (torch.bfloat16, 96, 64, "mma"),
    ("bfloat16", 128, 128, "mma"),
    (torch.bfloat16, 64, 96, "scalar"),      # (96, 64) is, (64, 96) is not
    (torch.bfloat16, 80, 80, "scalar"),      # outside the instantiated set
    (torch.bfloat16, 64, 64, "scalar"),
    (torch.float32, 128, 128, "scalar"),     # TF32 would miss the f32 bar
    ("float32", 64, 32, "scalar"),
    (torch.float16, 128, 128, "scalar"),
])
def test_decode_variant_boundaries(dtype, dk, dv, want):
    assert da.decode_variant(dtype, dk, dv) == want


def test_the_served_bf16_widths_take_the_tensor_cores():
    for name in ("eat-paper-8b", "qwen3-1.7b"):
        cfg = get_config(name)
        hd = cfg.resolved_head_dim
        assert da.decode_variant(cfg.dtype, hd, hd) == "mma"


def test_instantiated_pairs_match_the_source():
    """One REPRO_DECODE_MMA_CASE line per pair the rule routes to the
    tensor-core kernel, each a multiple of 16 up to 128."""
    pairs = [(int(a), int(b)) for a, b in re.findall(
        r"^\s*REPRO_DECODE_MMA_CASE\((\d+), (\d+)\)", CU.read_text(), re.M)]
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == set(da.MMA_HEAD_DIMS)
    assert all(d % 16 == 0 and 16 <= d <= da.MAX_HEAD_DIM
               for pair in pairs for d in pair)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    args = _case(1, 2, 200, 8, 2, 128, seed=3)
    before = (da.decode_attention_cuda.launches,
              dict(da.decode_attention_cuda.variant_launches))
    out = da.decode_attention(*args)
    assert torch.equal(out, da.decode_attention_plain(*args, scale=128 ** -0.5))
    assert (da.decode_attention_cuda.launches,
            da.decode_attention_cuda.variant_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(*args, impl="cuda")
