"""The tensor-core entropy probe's design, on the CPU.

The kernel (the "mma" variant in ``csrc/entropy_probe.cu``) runs only on the
card (``tests/test_torch_cuda.py``, marker ``gpu``).  Here its arithmetic is
emulated in torch float32 and held to ``next_token_entropy_plain``, to the
JAX reference ``_xla_entropy`` and, for Vp <= 2048, to
``entropy_probe_pallas`` in interpret mode, at the bar ``chip_smoke.py``
holds the kernel to: 1e-5 nats.  The emulation follows the kernel: bf16
inputs, whose products are exact in float32; each k-step of 16 summed from
zero (the tensor cores' sum of 16 exact products, here the float64 sum
rounded once to float32) and added to the float32 logit to nearest; (m, Z,
T), T taken about the max, of each warp's 16 columns of a 128-column tile,
merged into the warp's
running statistics over its block's tiles (block i of G: tiles i, i + G,
...); the block's 8 warps merged in warp order; the blocks' partials merged
by rescaling.
Also here: ``entropy_variant``'s rule, the served configs' routes, the
source's entry points and limits against the wrapper's, and CPU tensors
taking the plain version without counting a launch.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.entropy_probe.kernel import entropy_probe_pallas
from repro.kernels.entropy_probe.ops import _xla_entropy
from repro_torch.configs import get_config
from repro_torch.kernels.entropy_probe import ops as ep
from repro_torch.models.common import unembed_matrix

CU = Path(ep.__file__).resolve().parents[2] / "csrc" / "entropy_probe.cu"
TOL = 1e-5          # chip_smoke.py TOL["entropy_probe", "bfloat16"]
WARPS = 8           # csrc MMA_WARPS: 16 columns of each tile per warp
NEG = -1e30


def _logits(h, w):
    """float32 logits as the kernel forms them: per k-step of 16, the exact
    sum of bf16 products rounded once, added to the running logit."""
    hd, wd = h.double(), w.double()
    acc = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32)
    for k0 in range(0, h.shape[1], ep.MMA_K_STEP):
        step = hd[:, k0:k0 + ep.MMA_K_STEP] @ wd[k0:k0 + ep.MMA_K_STEP]
        acc = acc + step.float()
    return acc


def _merge(m, z, t, dim):
    """(m, Z, T) folded along ``dim`` in index order, by rescaling, each T
    moved to the largest max M."""
    M = m.amax(dim=dim, keepdim=True)
    s = torch.exp(m - M)
    zs, ts = (z * s).movedim(dim, 0), ((t + (m - M) * z) * s).movedim(dim, 0)
    Z, T = zs[0], ts[0]
    for i in range(1, zs.shape[0]):
        Z, T = Z + zs[i], T + ts[i]
    return M.squeeze(dim), Z, T


def _emulate(h, w, vocab, n_part):
    """The mma variant: h (B, d), w (d, Vp) bf16 in any layout; ``n_part``
    blocks, block i over tiles i, i + n_part, ..."""
    B, Vp = h.shape[0], w.shape[1]
    tv = ep.MMA_TILE_V
    n_tiles = -(-Vp // tv)
    lg = _logits(h, w)
    lg = torch.cat([lg, lg.new_zeros((B, n_tiles * tv - Vp))], dim=1)
    col = torch.arange(n_tiles * tv)
    valid = (col < vocab).reshape(n_tiles, WARPS, 16)
    x = lg.reshape(B, n_tiles, WARPS, 16).permute(1, 2, 0, 3)    # tile warp B 16
    x = torch.where(valid[:, :, None, :], x, NEG)
    parts = []
    for i in range(n_part):
        m = torch.full((WARPS, B), NEG)
        z, t = torch.zeros((WARPS, B)), torch.zeros((WARPS, B))
        for tile in range(i, n_tiles, n_part):
            xt, ok = x[tile], valid[tile][:, None, :]
            m_new = torch.maximum(m, xt.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            e = torch.where(ok, torch.exp(xt - m_new[..., None]), 0.0)
            t = (t + (m - m_new) * z) * alpha + torch.where(
                ok, e * (xt - m_new[..., None]), 0.0).sum(dim=-1)
            z = z * alpha + e.sum(dim=-1)
            m = m_new
        parts.append(_merge(m, z, t, 0))                        # warp order
    m, z, t = (torch.stack(p) for p in zip(*parts))             # (n_part, B)
    _, Z, T = _merge(m, z, t, 0)
    return torch.log(Z) - T / Z


def _inputs(B, d, Vp, layout, seed=0):
    """bf16 h (B, d) and w (d, Vp), made with numpy; logits of std ~2 as in
    chip_smoke.py.  ``tied``: w is the transposed view of a (Vp, d) table."""
    rng = np.random.default_rng(seed)
    h = torch.as_tensor(rng.normal(size=(B, d)), dtype=torch.float32)
    scale = 2.0 / math.sqrt(d)
    if layout == "tied":
        w = torch.as_tensor(rng.normal(size=(Vp, d)) * scale, dtype=torch.float32)
        w = w.to(torch.bfloat16).t()
    else:
        w = torch.as_tensor(rng.normal(size=(d, Vp)) * scale,
                            dtype=torch.float32).to(torch.bfloat16)
    return h.to(torch.bfloat16), w


def _jax(x):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


# (d, Vp, vocab, resident blocks): padded vocab everywhere, a ragged last
# tile (4104 = 32 tiles + 8 columns); ep.mma_blocks then gives blocks of 1,
# 4 and 3 tiles
CASES = [(64, 1024, 1000, 8), (128, 2048, 2047, 5), (96, 4104, 4000, 12)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("B", [1, 4, 32, 40])
@pytest.mark.parametrize("layout", ["untied", "tied"])
def test_emulated_kernel_arithmetic_holds_the_bar(case, B, layout):
    d, Vp, vocab, slots = case
    h, w = _inputs(B, d, Vp, layout, seed=B)
    assert ep.mma_layout(w) == layout and ep.entropy_variant(h, w) == "mma"
    out = _emulate(h, w, vocab, ep.mma_blocks(Vp, slots))
    assert out.shape == (B,) and bool(torch.isfinite(out).all())
    assert float(out.max()) <= math.log(vocab)
    refs = [ep.next_token_entropy_plain(h, w, vocab),
            torch.tensor(np.asarray(_xla_entropy(_jax(h), _jax(w), vocab)))]
    if Vp <= 2048:
        refs.append(torch.tensor(np.asarray(entropy_probe_pallas(
            _jax(h), _jax(w), vocab, block_b=8, block_v=256, interpret=True))))
    for ref in refs:
        err = (out - ref).abs().max().item()
        assert err <= TOL, err


def test_partials_and_padded_columns_are_identities():
    """One partial or one per tile: the same entropy to float32 noise; a
    vocab of one column gives exactly 0."""
    h, w = _inputs(4, 64, 1024, "untied", seed=9)
    one = _emulate(h, w, 1000, 1)
    per_tile = _emulate(h, w, 1000, 8)
    assert (one - per_tile).abs().max().item() < 1e-6
    assert torch.equal(_emulate(h, w, 1, 8), torch.zeros(4))


def _peaked(B, d, Vp, top, seed):
    """bf16 h and untied w whose logits are of std ~2 but for one column a
    row, at ~``top``: one token takes nearly all the mass, as at gemma-2b's
    2-layer float32 forward on the card (largest logit 27.45, entropy ~0)."""
    rng = np.random.default_rng(seed)
    h = torch.as_tensor(rng.normal(size=(B, d)), dtype=torch.float32)
    h = h.to(torch.bfloat16).float()
    w = torch.as_tensor(rng.normal(size=(d, Vp)) * 2.0 / math.sqrt(d), dtype=torch.float32)
    for b, j in enumerate(rng.choice(Vp - 200, size=B, replace=False)):
        w[:, j] = h[b] * top / float(h[b] @ h[b])
    return h.to(torch.bfloat16), w.to(torch.bfloat16)


@pytest.mark.parametrize("top", [20, 25, 30])
@pytest.mark.parametrize("seed", [1, 2])
def test_peaked_distributions_hold_the_bar_against_float64(top, seed):
    """Entropies of 4e-3 down to 3e-7 nats at largest logits of 20-30:
    the emulated kernel (157 partials) and the plain version within 1e-5
    of the float64 entropy of the kernel's logits.  With T taken about 0
    and H = m + log Z - T / Z, as the reference takes it, the same
    emulation read 1.9e-5 to 4.8e-5 off at tops 20 and 25: each sum that
    adds a small term to m-sized Z-weighted logits rounds to an ulp of m."""
    h, w = _peaked(8, 256, 20_000, top, seed)
    lp = torch.log_softmax(_logits(h, w)[:, :19_900].double(), dim=-1)
    truth = -(lp.exp() * lp).sum(dim=-1)
    for out in (_emulate(h, w, 19_900, 157), ep.next_token_entropy_plain(h, w, 19_900)):
        assert bool(torch.isfinite(out).all()) and bool((out >= 0).all())
        err = (out.double() - truth).abs().max().item()
        assert err <= TOL, (top, err)


def _view(shape, strides, offset=0, dtype=torch.bfloat16):
    base = torch.zeros(offset + 1 + sum((n - 1) * s for n, s in zip(shape, strides)),
                       dtype=dtype)
    return base.as_strided(shape, strides, offset)


H = torch.zeros((4, 64), dtype=torch.bfloat16)


@pytest.mark.parametrize("w,want", [
    (_view((64, 1024), (1024, 1)), "mma"),            # untied, contiguous
    (_view((64, 1000), (1024, 1)), "mma"),            # untied, vocab sliced
    (_view((64, 1024), (1, 64)), "mma"),              # tied view
    (_view((64, 1000), (1, 72)), "mma"),              # tied, table row padded
    (_view((64, 257), (257, 1)), "scalar"),           # Vp 257: sd % 8
    (_view((64, 1024), (1, 68)), "scalar"),           # sv % 8
    (_view((64, 1024), (2048, 2)), "scalar"),         # no unit stride
    (_view((64, 1024), (1024, 1), offset=4), "scalar"),  # 8 bytes off
    (_view((64, 1024), (1024, 1), dtype=torch.float32), "scalar"),
])
def test_entropy_variant_boundaries(w, want):
    h = H.float() if w.dtype == torch.float32 else H
    assert ep.entropy_variant(h, w) == want


def test_entropy_variant_needs_h_aligned_and_d_multiple_of_8():
    w = _view((64, 1024), (1024, 1))
    assert ep.entropy_variant(H, w) == "mma"
    assert ep.entropy_variant(torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:]
                              .view(4, 64), w) == "scalar"
    assert ep.entropy_variant(H.float(), w) == "scalar"
    assert ep.entropy_variant(torch.zeros((4, 60), dtype=torch.bfloat16),
                              _view((60, 1024), (1024, 1))) == "scalar"
    assert ep.entropy_variant(torch.zeros((4, 60), dtype=torch.bfloat16),
                              _view((60, 1024), (1, 64))) == "scalar"


@pytest.mark.parametrize("name,layout", [("eat-paper-8b", "untied"),
                                         ("qwen3-1.7b", "tied"),
                                         ("mamba2-2.7b", "untied")])
def test_served_configs_take_the_tensor_cores(name, layout):
    """The unembedding each serve probes with (meta tensors: shapes and
    strides of the real tables, no storage)."""
    cfg = get_config(name)
    d, Vp = cfg.d_model, cfg.padded_vocab
    p = {"embedding": torch.empty((Vp, d), dtype=torch.bfloat16, device="meta")}
    if not cfg.tie_embeddings:
        p["lm_head"] = torch.empty((d, Vp), dtype=torch.bfloat16, device="meta")
    w = unembed_matrix(p, cfg)
    assert cfg.dtype == "bfloat16" and ep.mma_layout(w) == layout
    for B in (1, 4, 32):
        h = torch.empty((B, d), dtype=torch.bfloat16, device="meta")
        assert ep.entropy_variant(h, w) == "mma", (name, B)


def test_entry_points_and_limits_match_the_source():
    """Each C entry point has the wrapper's argument count and launches
    KERNELS_PER_CALL kernels; the tile widths, k-step, rows per group and
    the copy size are the wrapper's."""
    src = CU.read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(entries) == set(ep._SIGNATURES)
    for name, params in entries.items():
        assert len(params.split(",")) == len(ep._SIGNATURES[name]), name
    const = {k: int(v) for k, v in re.findall(r"\b(\w+) = (\d+)[;,]", src)}
    assert const["TV"] == ep.SCALAR_TILE_V
    assert const["MMA_THREADS"] // 32 == WARPS
    assert WARPS * 16 == ep.MMA_TILE_V          # TVM = MMA_WARPS * 16
    for layout in ("UNTIED", "TIED"):
        assert const[f"TK_{layout}"] % ep.MMA_K_STEP == 0
    assert 8 * const["MAX_NT"] == ep.MMA_ROWS
    assert "m16n8k16" in src
    launch = src.split("// ------------------------------------------------------------------ launch")[1]
    scalar = launch.split("cudaError_t launch_scalar(")[1].split("\n}\n")[0]
    mma = src.split('extern "C" int entropy_probe_mma(')[1].split("\n}\n")[0]
    assert scalar.count("<<<") == ep.KERNELS_PER_CALL["scalar"]
    assert mma.count("<<<") == ep.KERNELS_PER_CALL["mma"]
    guard = mma.split("return (int)cudaErrorInvalidValue")[0]
    for cond in ("d % 8", "ld % 8", "% 16"):
        assert cond in guard, cond


@pytest.mark.parametrize("Vp,slots,want", [(152_064, 396, 396), (152_064, 264, 238),
                                           (50_432, 396, 394), (1000, 396, 8),
                                           (64, 396, 1), (1000, 3, 3),
                                           (256_000, 396, 334), (256_000, 264, 250),
                                           (92_416, 396, 361)])
def test_mma_grid_gives_every_block_the_same_tiles(Vp, slots, want):
    """At most ``slots`` blocks, each of ceil(tiles / slots) tiles but the
    last few (one fewer)."""
    n_part = ep.mma_blocks(Vp, slots)
    assert n_part == want
    n_tiles = -(-Vp // ep.MMA_TILE_V)
    sizes = [len(range(i, n_tiles, n_part)) for i in range(n_part)]
    assert max(sizes) == -(-n_tiles // slots) and max(sizes) - min(sizes) <= 1


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    h, w = _inputs(3, 64, 1024, "tied", seed=3)
    before = (ep.entropy_probe_cuda.launches, dict(ep.entropy_probe_cuda.variant_launches))
    out = ep.next_token_entropy(h, w, 1000)
    assert torch.equal(out, ep.next_token_entropy_plain(h, w, 1000))
    assert (ep.entropy_probe_cuda.launches, ep.entropy_probe_cuda.variant_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ep.next_token_entropy(h, w, 1000, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ep.entropy_probe_cuda(h, w, 1000, variant="mma")
