"""The tensor-core SSD scan's design, on the CPU.

The kernels (the "mma" variant in ``csrc/ssd_scan.cu``) run only on the card
(``tests/test_torch_cuda.py``, marker ``gpu``).  Here their staged arithmetic
is emulated in torch float32 and held to ``ssd_scan_plain`` and to the JAX
reference ``ssd_chunked`` at the bar ``chip_smoke.py`` holds the kernel to:
1e-5 of the largest magnitude, for y and for the final state each.  The
emulation follows the kernels: the chunk's cumsum in step order; C B^T once
per group; the chunk states (w * B)^T U with w_s = exp(cs_L - cs_s); the pass
over chunks; y = exp(cs_t) (C h_before) + M U with M = (C B^T) exp(cs_t -
cs_s) on the causal triangle.  Every product is 3xTF32: each operand x splits
into hi = tf32(x) and lo = tf32(x - hi), tf32 being cvt.rna's rounding (to
nearest, ties away from zero, 10 mantissa bits) done by integer operations
on the float32 bits, and the product is lo.hi + hi.lo + hi.hi in float32.
One TF32 product instead misses the bar, which is why the kernels split.
Where the cumsum falls below -1000, the float32 rounding of the cumsum (kept
in step order, as the kernels keep it; the CPU ``torch.cumsum`` sums in
double) alone moves y by about the bar, in the scalar kernel too; there the
split's own error is held against the same staging with exact float32
products.
Also here: ``ssd_variant``'s rule, the source's entry points and limits
against the wrapper's, and CPU tensors taking the plain version without
counting a launch.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ss

CU = Path(ss.__file__).resolve().parents[2] / "csrc" / "ssd_scan.cu"
REL_TOL = 1e-5  # chip_smoke.py SSD_REL_TOL


def _tf32(x):
    """cvt.rna.tf32.f32 on float32 bits: add half a tf32 ulp to the
    magnitude, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    return _tf32(a) @ _tf32(b)


def _mm_f32(a, b):
    return a @ b


def _emulate(u, logd, Bm, Cm, *, chunk, h0=None, mm=_mm3):
    """The mma variant's four stages, every product through ``mm``."""
    Bsz, S, nh, hp = u.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, L = nh // G, chunk
    pad = (-S) % L
    pad_t = lambda x: torch.cat(  # noqa: E731  zeros past S: logd 0, u = B = C = 0
        [x, x.new_zeros((Bsz, pad) + tuple(x.shape[2:]))], dim=1)
    u, logd, Bm, Cm = (pad_t(x) for x in (u, logd, Bm, Cm))
    nc = (S + pad) // L
    uc = u.reshape(Bsz, nc, L, nh, hp).permute(0, 3, 1, 2, 4)      # b h c l p
    dc = logd.reshape(Bsz, nc, L, nh).permute(0, 3, 1, 2)          # b h c l
    bg = Bm.reshape(Bsz, nc, L, G, N).permute(0, 3, 1, 2, 4)       # b g c l n
    cg = Cm.reshape(Bsz, nc, L, G, N).permute(0, 3, 1, 2, 4)
    bh, ch = (x.repeat_interleave(rep, dim=1) for x in (bg, cg))   # b h c l n
    cs = dc.clone()
    for t in range(1, L):                                          # step order
        cs[..., t] = cs[..., t - 1] + dc[..., t]
    tot = cs[..., -1]                                              # b h c
    # 1. C B^T once per group
    cb = mm(cg, bg.transpose(-1, -2)).repeat_interleave(rep, dim=1)
    # 2. chunk states
    w = torch.exp(tot[..., None] - cs)
    st = mm((w[..., None] * bh).transpose(-1, -2), uc)             # b h c n p
    # 3. the pass over chunks
    h = torch.zeros((Bsz, nh, N, hp)) if h0 is None else h0.clone()
    before = []
    for c in range(nc):
        before.append(h)
        h = torch.exp(tot[:, :, c])[..., None, None] * h + st[:, :, c]
    hb = torch.stack(before, dim=2)
    # 4. outputs
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    m = torch.where(tri, cb * torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    y = torch.exp(cs)[..., None] * mm(ch, hb) + mm(m, uc)          # b h c l p
    y = y.permute(0, 2, 3, 1, 4).reshape(Bsz, nc * L, nh, hp)[:, :S]
    return y, h


def _inputs(B, S, nh, hp, G, N, factors, with_h0, seed=0):
    """Scan inputs shaped as ssm_forward makes them: logd = -dt * a_h with dt
    log-uniform in [1e-3, 1e-1] and a_h the heads' decay factors."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(B, S, nh)))
    u = t(rng.normal(size=(B, S, nh, hp)) * 0.3)
    logd = t(-dt * np.asarray(factors, np.float64))
    Bm = t(rng.normal(size=(B, S, G, N)) * 0.4)
    Cm = t(rng.normal(size=(B, S, G, N)) * 0.4)
    h0 = t(rng.normal(size=(B, nh, N, hp)) * 0.2) if with_h0 else None
    return (u, logd, Bm, Cm), h0


# mamba2-2.7b's head shapes (chunk 128, d_state 128, head_dim 64, one group)
# over a ragged 3-chunk prompt with decay factors across the 1..80 of the
# serve's heads (chip_smoke.py ssd_case), the steepest most; the same with
# steeper heads, whose within-chunk cumsum falls below -1000; G < nh at the
# sweep widths of tests/test_ssm.py
CASES = {
    "mamba2_heads": dict(B=2, S=300, nh=8, hp=64, G=1, N=128, chunk=128,
                         factors=[1, 10, 20, 40, 60, 70, 75, 80]),
    "steep_heads": dict(B=2, S=300, nh=8, hp=64, G=1, N=128, chunk=128,
                        factors=[1, 5, 50, 80, 200, 400, 500, 1000]),
    "groups": dict(B=2, S=37, nh=4, hp=8, G=2, N=16, chunk=16,
                   factors=[1, 2, 3, 4]),
}


def _case(name, with_h0):
    c = dict(CASES[name])
    chunk, factors = c.pop("chunk"), c.pop("factors")
    args, h0 = _inputs(**c, factors=factors, with_h0=with_h0)
    return args, h0, chunk


def _rel_err(out, ref):
    return (out - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.parametrize("name", ["mamba2_heads", "groups"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_emulated_kernel_arithmetic_holds_the_bar(name, with_h0):
    args, h0, chunk = _case(name, with_h0)
    y, h = _emulate(*args, chunk=chunk, h0=h0)
    yp, hp_ = ss.ssd_scan_plain(*args, chunk=chunk, h0=h0)
    yj, hj = jssm.ssd_chunked(*(jnp.asarray(a.numpy()) for a in args), chunk,
                              None if h0 is None else jnp.asarray(h0.numpy()))
    yj, hj = torch.tensor(np.asarray(yj)), torch.tensor(np.asarray(hj))
    for out, refs in ((y, (yp, yj)), (h, (hp_, hj))):
        assert bool(torch.isfinite(out).all())
        for ref in refs:
            assert out.shape == ref.shape
            assert _rel_err(out, ref) <= REL_TOL, _rel_err(out, ref)


@pytest.mark.parametrize("with_h0", [False, True])
def test_the_split_holds_where_the_cumsum_underflows(with_h0):
    """Cumsums below -1000, where exp(cs) alone is 0 and only differences
    of cumsums give the decays: 3xTF32 stays within a tenth of the bar of
    the same stages with exact float32 products, for y and h_final."""
    args, h0, chunk = _case("steep_heads", with_h0)
    cs = torch.cumsum(args[1][:, :chunk], dim=1)
    assert cs.min().item() < -1000 and torch.exp(cs).min().item() == 0.0
    three = _emulate(*args, chunk=chunk, h0=h0)
    exact = _emulate(*args, chunk=chunk, h0=h0, mm=_mm_f32)
    for out, ref in zip(three, exact):
        assert bool(torch.isfinite(out).all())
        assert _rel_err(out, ref) < 0.1 * REL_TOL, _rel_err(out, ref)


def test_one_tf32_product_misses_the_bar():
    """A single TF32 product (no lo terms) is many times past the 1e-5 bar
    at mamba2-2.7b's head shapes; the 3xTF32 split is well inside it."""
    args, h0, chunk = _case("mamba2_heads", True)
    ref, _ = ss.ssd_scan_plain(*args, chunk=chunk, h0=h0)
    one, _ = _emulate(*args, chunk=chunk, h0=h0, mm=_mm1)
    three, _ = _emulate(*args, chunk=chunk, h0=h0)
    exact, _ = _emulate(*args, chunk=chunk, h0=h0, mm=_mm_f32)
    assert _rel_err(one, ref) > 10 * REL_TOL, _rel_err(one, ref)
    assert _rel_err(three, ref) <= REL_TOL
    assert _rel_err(three, exact) < 0.1 * REL_TOL, _rel_err(three, exact)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                  # a tf32 value: kept
    half = 2.0 ** -11                       # half a tf32 ulp at 1.0
    x = torch.tensor([one, 1.0 + half, -(1.0 + half), 1.0 + half - 2.0 ** -23,
                      3.0e-39, 0.0], dtype=torch.float32)
    want = torch.tensor([one, one, -one, 1.0, 3.0e-39, 0.0], dtype=torch.float32)
    got = _tf32(x)
    assert torch.equal(got[:4], want[:4])
    assert got[5].item() == 0.0
    # every result carries at most 10 mantissa bits
    assert not (_tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("chunk,d_state,head_dim,want", [
    (128, 128, 64, "mma"),
    (16, 16, 16, "mma"),
    (8, 8, 8, "mma"),
    (32, 32, 16, "mma"),
    (4, 8, 8, "scalar"),       # the sweep's chunk 4: under one k-step
    (12, 16, 16, "scalar"),
    (128, 100, 64, "scalar"),
    (128, 128, 60, "scalar"),
])
def test_ssd_variant_boundaries(chunk, d_state, head_dim, want):
    assert ss.ssd_variant(chunk, d_state, head_dim) == want


def test_the_ssm_configs_take_the_tensor_cores():
    for name in ("mamba2-2.7b", "tiny-ssm"):
        s = get_config(name).ssm
        assert ss.ssd_variant(s.chunk, s.d_state, s.head_dim) == "mma", name


def test_entry_points_and_limits_match_the_source():
    """Each C entry point has the wrapper's argument count, the mma entry
    launches KERNELS_PER_CALL["mma"] kernels, and the source's limits are
    the wrapper's."""
    src = CU.read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(entries) == set(ss._SIGNATURES)
    for name, params in entries.items():
        assert len(params.split(",")) == len(ss._SIGNATURES[name]), name
    for name, n in (("ssd_scan_mma", ss.KERNELS_PER_CALL["mma"]),
                    ("ssd_scan", ss.KERNELS_PER_CALL["scalar"])):
        body = src.split(f'extern "C" int {name}(')[1].split("\n}\n")[0]
        assert body.count("<<<") == n, name
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["N_MAX"] == ss.MAX_STATE
    assert 32 * const["RS"] == ss.MAX_CHUNK
    assert 32 * const["RP"] == ss.MAX_HEAD_DIM
    mma_body = src.split('extern "C" int ssd_scan_mma(')[1]
    for dim in ("hp", "N", "L"):
        assert f"{dim} % {ss.MMA_ALIGN}" in mma_body.split("return")[0]


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    args, h0, chunk = _case("groups", True)
    before = (ss.ssd_scan_cuda.launches, dict(ss.ssd_scan_cuda.variant_launches))
    out = ss.ssd_scan(*args, chunk=chunk, h0=h0)
    ref = ss.ssd_scan_plain(*args, chunk=chunk, h0=h0)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (ss.ssd_scan_cuda.launches, ss.ssd_scan_cuda.variant_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan(*args, chunk=chunk, h0=h0, impl="cuda")
