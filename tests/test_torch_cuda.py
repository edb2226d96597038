"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and is
skipped where there is none (no card, so no kernel can build or run).  On a
machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: kernel and plain version both compute in float32 from the same
inputs and differ only by summation order, so 2e-5 in float32 (the bar of
the reference's attention kernel tests) and 3e-2 in bfloat16 (one output
rounding at most); 1e-5 for the entropy, whose float32 output is computed
in float32 from either input type (both variants: bf16 products are exact
in float32 on the tensor cores); 1e-5 of the largest output magnitude for
the SSD scan (float32 only; y and the final state each against their own
largest value; the tensor-core variant, 3xTF32, and the scalar one alike).  The paged kernel is held to chip_smoke.py's bars: 1e-6
in float32 and one bf16 ulp of the larger output in bfloat16 (it rounds
every probability where the plain scan does: against the running max of
every earlier page, from scores summed in the plain version's order), and
its paged and ring calls must agree bit for bit.  The flash-decode kernel
keeps its probabilities float32-exact like its plain version (the bf16
tensor-core kernel as two bf16 parts): 2e-5 in float32, and in bfloat16
chip_smoke.py's bar, one bf16 ulp of the larger output plus 1e-6.  bf16 flash
(the tensor-core kernel) is also held to chip_smoke.py's bar, one bf16 ulp
plus 2^-7 times the attention of |v|, and its output must not change, bit
for bit, when masked key slots are appended.  TF32 is off.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.entropy_probe import ops as ep
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.ssd_scan import ops as ss

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev, scale=1.0):
    return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                           device=dev).to(dtype)


def _flash_positions(B, Sq, Skv, layout, dev):
    """(q_pos, kv_pos) int32.  ``tail3``: queries at 4.., keys 0.. with the
    last 3 slots empty; ``leftpad``: a left-padded prompt (Sq == Skv), row
    b with 100 b pad slots at position -1; ``end``: the Sq queries at the
    last Sq keys; ``empty``: ``end`` with no valid key in row 0."""
    if layout == "tail3":
        qp = (torch.arange(Sq, device=dev) + 4).expand(B, Sq)
        kp = torch.arange(Skv, device=dev).expand(B, Skv).clone()
        kp[:, -3:] = -1
    elif layout == "leftpad":
        ar = torch.arange(Skv, device=dev)[None]
        pad = torch.arange(B, device=dev)[:, None] * 100
        kp = torch.where(ar >= pad, ar - pad, -1)
        qp = kp
    else:
        kp = torch.arange(Skv, device=dev).expand(B, Skv).clone()
        qp = torch.arange(Skv - Sq, Skv, device=dev).expand(B, Sq)
        if layout == "empty":
            kp[0] = -1
    return qp.to(torch.int32).contiguous(), kp.to(torch.int32).contiguous()


def _within_flash_bar(out, ref, q, k, v, qp, kp, kw):
    """The bf16 bar of chip_smoke.py: one bf16 ulp of the larger output plus
    2^-7 times the attention of |v| (each probability is rounded to bf16
    against another running max than the plain version's)."""
    spread = fa.attention_plain(q, k, v.abs(), qp, kp, **kw).float()
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= ulp + 2.0 ** -7 * spread).all())


# B, Sq, Skv, Hq, Hkv, Dk, Dv, window, causal, layout
FLASH_CASES = [
    (1, 16, 16, 1, 1, 32, 32, 0, True, "tail3"),
    (2, 33, 47, 4, 2, 64, 64, 8, True, "tail3"),
    (2, 40, 40, 8, 2, 128, 128, 0, True, "tail3"),
    (1, 12, 30, 4, 1, 96, 64, 0, True, "tail3"),
    (2, 9, 21, 4, 4, 32, 32, 0, False, "tail3"),
]
# bf16 only, for the tensor-core kernel: the 8B prefill shape, the gather
# decode read (Sq 1 and 2 over 700 keys), ragged tiles, an empty row, a
# window, head dim 16 and (96, 64)
FLASH_BF16_CASES = [
    (2, 512, 512, 32, 8, 128, 128, 0, True, "leftpad"),
    (2, 1, 700, 32, 8, 128, 128, 0, True, "end"),
    (2, 2, 700, 32, 8, 128, 128, 0, True, "end"),
    (2, 100, 300, 8, 2, 128, 128, 0, True, "end"),
    (2, 100, 300, 8, 2, 128, 128, 0, True, "empty"),
    (2, 200, 200, 8, 2, 64, 64, 64, True, "leftpad"),
    (2, 150, 150, 4, 2, 16, 16, 0, True, "leftpad"),
    (2, 130, 170, 8, 2, 96, 64, 0, True, "end"),
]


@pytest.mark.parametrize(
    "case,dtype",
    [(c, d) for c in FLASH_CASES for d in DTYPES]
    + [(c, torch.bfloat16) for c in FLASH_BF16_CASES])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Skv, Hq, Hkv, Dk, Dv, window, causal, layout = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, Hq, Dk), dtype, cuda)
    k = _randn(rng, (B, Skv, Hkv, Dk), dtype, cuda)
    v = _randn(rng, (B, Skv, Hkv, Dv), dtype, cuda)
    qp, kp = _flash_positions(B, Sq, Skv, layout, cuda)
    kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(Dk))
    out = fa.flash_attention_cuda(q, k, v, qp, kp, **kw)
    ref = fa.attention_plain(q, k, v, qp, kp, **kw)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert _within_flash_bar(out, ref, q, k, v, qp, kp, kw)
    if layout == "empty":
        assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "mma"),
                                           (torch.float32, "scalar")])
def test_flash_routes_and_counts_per_variant(cuda, dtype, variant):
    """A bf16 call at D 128 launches the tensor-core kernel, a float32 call
    the scalar one: one launch of that variant, none of the other."""
    assert fa.flash_variant(dtype, 128, 128) == variant
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, 64, 4, 128), dtype, cuda)
    k = _randn(rng, (1, 64, 2, 128), dtype, cuda)
    qp, kp = _flash_positions(1, 64, 64, "end", cuda)
    before = dict(fa.flash_attention_cuda.variant_launches)
    n = fa.flash_attention_cuda.launches
    fa.attention(q, k, k, qp, kp)                          # auto -> the kernel
    after = fa.flash_attention_cuda.variant_launches
    assert fa.flash_attention_cuda.launches == n + 1
    assert {x: after[x] - before[x] for x in after} == {
        x: int(x == variant) for x in after}


@pytest.mark.parametrize("Sq,Skv", [(512, 512), (300, 300), (2, 700)])
def test_flash_mma_ignores_trailing_masked_slots_bitwise(cuda, Sq, Skv):
    """Appending 64 key slots at position -1 (random K/V) leaves the bf16
    output bitwise unchanged: the paged == ring property of the serves."""
    rng = np.random.default_rng(4)
    B, Hq, Hkv, D = 2, 32, 8, 128
    q = _randn(rng, (B, Sq, Hq, D), torch.bfloat16, cuda)
    k = _randn(rng, (B, Skv + 64, Hkv, D), torch.bfloat16, cuda)
    v = _randn(rng, (B, Skv + 64, Hkv, D), torch.bfloat16, cuda)
    qp, kp = _flash_positions(B, Sq, Skv, "leftpad" if Sq == Skv else "end", cuda)
    kp_long = torch.cat([kp, torch.full((B, 64), -1, dtype=torch.int32,
                                        device=cuda)], 1)
    kw = dict(scale=1.0 / math.sqrt(D))
    short = fa.flash_attention_cuda(q, k[:, :Skv].contiguous(),
                                    v[:, :Skv].contiguous(), qp, kp, **kw)
    long = fa.flash_attention_cuda(q, k, v, qp, kp_long, **kw)
    assert torch.equal(short, long)


def _paged(rng, dev, dtype, *, m, Hq, Hkv, D, ps=16, NB=12, rows=None):
    """Pools holding rows of mapped pages with holes, the matching ring.
    ``rows``: the logical blocks mapped in each row, of NB (default: three
    rows of the first NB - 2 blocks, every fourth one a hole)."""
    if rows is None:
        rows = [[j for j in range(NB - 2) if (j + b) % 4 != 3] for b in range(3)]
    B = len(rows)
    P = sum(len(r) for r in rows) + 1
    kpool = _randn(rng, (P, ps, Hkv, D), dtype, dev)
    vpool = _randn(rng, (P, ps, Hkv, D), dtype, dev)
    NBK = max(1, max(len(r) for r in rows))
    pages = np.zeros((B, NBK), np.int32)
    logical = np.zeros((B, NBK), np.int32)
    counts = np.zeros(B, np.int32)
    kv_pos = np.full((B, NB * ps), -1, np.int32)
    nxt = 1
    for b, blocks in enumerate(rows):
        for r, blk in enumerate(blocks):
            pages[b, r], logical[b, r] = nxt, blk
            nxt += 1
            fill = ps if blk != blocks[-1] else ps // 2 + 1
            kv_pos[b, blk * ps:blk * ps + fill] = np.arange(blk * ps, blk * ps + fill)
        counts[b] = len(blocks)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pages, logical, counts, kv_pos = t(pages), t(logical), t(counts), t(kv_pos)
    bpos = pa.block_positions(kv_pos, pages, logical, ps).contiguous()
    kr = torch.zeros((B, NB * ps, Hkv, D), dtype=dtype, device=dev)
    vr = torch.zeros_like(kr)
    for b in range(B):
        for r in range(int(counts[b])):
            blk = int(logical[b, r])
            kr[b, blk * ps:(blk + 1) * ps] = kpool[pages[b, r]]
            vr[b, blk * ps:(blk + 1) * ps] = vpool[pages[b, r]]
    C = NB * ps
    q = _randn(rng, (B, m, Hq, D), dtype, dev)
    qp = torch.arange(C - m, C, device=dev, dtype=torch.int32).expand(B, m).contiguous()
    return q, kpool, vpool, pages, counts, bpos, qp, kr, vr, kv_pos, logical


def _paged_within_bar(out, ref, dtype):
    """chip_smoke.py's paged bars: 1e-6 in float32; in bf16 one ulp of the
    larger output, element by element."""
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        return diff.max().item() <= 1e-6
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return bool((diff <= ulp).all())


def _check_paged(dev, dtype, *, window=0, seed=1, **case):
    """Kernel vs plain within the bars, and the paged call equal to the ring
    call of the same cache bit for bit.  Returns the kernel's output."""
    q, kp, vp, pages, counts, bpos, qp, kr, vr, kv_pos, logical = _paged(
        np.random.default_rng(seed), dev, dtype, **case)
    NB = kv_pos.shape[1] // kp.shape[1]
    kw = dict(scale=1.0 / math.sqrt(q.shape[-1]), window=window)
    out = pa.paged_attention_cuda(q, kp, vp, pages, counts, bpos, qp,
                                  logical=logical, num_blocks=NB, **kw)
    ref = pa.paged_attention_plain(q, kp, vp, pages, counts, bpos, qp, **kw)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert _paged_within_bar(out, ref, dtype), (out.float() - ref.float()).abs().max()
    ring = pa.ring_decode_attention(q, kr, vr, qp, kv_pos, page_size=kp.shape[1],
                                    impl="cuda", **kw)
    assert torch.equal(out, ring)
    return out


@pytest.mark.parametrize("m,Hq,Hkv", [(1, 2, 2), (2, 4, 2), (1, 8, 2), (2, 8, 2),
                                      (8, 4, 4), (1, 32, 8)])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_matches_plain_and_ring(cuda, m, Hq, Hkv, window, dtype):
    """m*g in {1, 4, 8, 8, 8, 4} over g in {1, 2, 4}; plus paged == ring
    bitwise through the same kernel."""
    _check_paged(cuda, dtype, window=window, m=m, Hq=Hq, Hkv=Hkv, D=64)


# the split's edges (K = 4 blocks at page 16): rows of 128 mapped pages
# whose holes empty whole splits; a row with nothing mapped and a row whose
# one page is in the last split; 32 query rows (m 8, g 4); a window that
# masks every split but the last two
PAGED_SPLIT_CASES = {
    "holes128": dict(m=1, Hq=32, Hkv=8, D=128, NB=160,
                     rows=[[j for j in range(160) if not 16 * (b + 1) <= j < 16 * (b + 1) + 32]
                           for b in range(3)]),
    "empty_and_last": dict(m=2, Hq=8, Hkv=2, D=64, NB=41,
                           rows=[[], [40], list(range(0, 30, 2))]),
    "rows32": dict(m=8, Hq=16, Hkv=4, D=64, NB=24),
    "window": dict(m=1, Hq=8, Hkv=2, D=128, NB=64, rows=[list(range(63))] * 2,
                   window=100),
}


@pytest.mark.parametrize("name", list(PAGED_SPLIT_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_splits_match_plain_and_ring(cuda, name, dtype):
    assert pa.split_plan(16, 64) == (4, 16)     # the K the cases are cut for
    out = _check_paged(cuda, dtype, **PAGED_SPLIT_CASES[name])
    if name == "empty_and_last":    # counts 0: exactly 0
        assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("case", [(1, 16, 64, 64), (3, 32, 257, 200),
                                  (5, 128, 2048, 2047), (16, 256, 4096, 4000),
                                  (40, 128, 1024, 1000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_entropy_kernel_matches_plain(cuda, case, dtype):
    """B = 40 spans three row groups of the scalar kernel (16 + 16 + 8) and
    two of the tensor-core kernel (32 + 8).  W as given and as the tied
    view, each through the route ``entropy_variant`` picks and through
    every variant it may take, forced."""
    B, d, Vp, vocab = case
    rng = np.random.default_rng(2)
    h = _randn(rng, (B, d), dtype, cuda)
    w = _randn(rng, (d, Vp), dtype, cuda, scale=0.3)
    ref = ep.next_token_entropy_plain(h, w, vocab)
    # a tied config passes the transposed (Vp, d) table as a strided view
    wt = w.t().contiguous().t()
    bf16 = dtype == torch.bfloat16
    assert ep.entropy_variant(h, wt) == ("mma" if bf16 else "scalar")
    assert ep.entropy_variant(h, w) == ("mma" if bf16 and Vp % 8 == 0 else "scalar")
    for ww in (w, wt):
        want = ep.entropy_variant(h, ww)
        n = ep.entropy_probe_cuda.launches
        before = dict(ep.entropy_probe_cuda.variant_launches)
        out = ep.entropy_probe_cuda(h, ww, vocab)
        after = ep.entropy_probe_cuda.variant_launches
        assert ep.entropy_probe_cuda.launches == n + 1
        assert {x: after[x] - before[x] for x in after} == \
            {x: int(x == want) for x in after}
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
        for variant in (("mma", "scalar") if want == "mma" else ("scalar",)):
            torch.testing.assert_close(
                ep.entropy_probe_cuda(h, ww, vocab, variant=variant), ref,
                atol=1e-5, rtol=1e-5)


def test_entropy_misaligned_layouts_take_the_scalar_kernel(cuda):
    """bf16 W off 16-byte alignment, a table row of 68 (sv % 8), d 60, and
    float32 each take the scalar kernel, within the bar; forcing the mma
    variant on them raises."""
    rng = np.random.default_rng(3)
    h = _randn(rng, (4, 64), torch.bfloat16, cuda)
    w = _randn(rng, (64, 1024), torch.bfloat16, cuda, scale=0.3)
    shifted = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda)[1:].view(w.shape)
    shifted.copy_(w)
    table = _randn(rng, (1024, 68), torch.bfloat16, cuda, scale=0.3)
    h60 = _randn(rng, (4, 60), torch.bfloat16, cuda)
    w60 = _randn(rng, (60, 1024), torch.bfloat16, cuda, scale=0.3)
    cases = [(h, shifted), (h, table[:, :64].t()), (h60, w60),
             (h.float(), w.float())]
    for hh, ww in cases:
        assert ep.entropy_variant(hh, ww) == "scalar", ww.stride()
        before = ep.entropy_probe_cuda.variant_launches["scalar"]
        out = ep.entropy_probe_cuda(hh, ww, 1000)
        assert ep.entropy_probe_cuda.variant_launches["scalar"] == before + 1
        torch.testing.assert_close(out, ep.next_token_entropy_plain(hh, ww, 1000),
                                   atol=1e-5, rtol=1e-5)
        with pytest.raises(ValueError, match="mma variant"):
            ep.entropy_probe_cuda(hh, ww, 1000, variant="mma")
    with pytest.raises(ValueError, match="unknown"):
        ep.entropy_probe_cuda(h, w, 1000, variant="tensor")


@pytest.mark.parametrize("layout", ["untied", "tied"])
def test_entropy_mma_two_launches_and_no_state(cuda, layout):
    """One call of the tensor-core variant runs two kernels (the profiler's
    count; an empty session is repeated, as chip_smoke.py's device_kernels
    does); repeated calls, calls on two streams at once and a CUDA-graph
    replay each give the eager output bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(4)
    sets = []
    for _ in range(2):
        h = _randn(rng, (4, 256), torch.bfloat16, cuda)
        w = _randn(rng, (256, 8192), torch.bfloat16, cuda, scale=0.3)
        sets.append((h, w.t().contiguous().t() if layout == "tied" else w))
    run = [lambda h=h, w=w: ep.entropy_probe_cuda(h, w, 8000) for h, w in sets]
    assert all(ep.entropy_variant(h, w) == "mma" for h, w in sets)
    refs = [f() for f in run]
    torch.cuda.synchronize()
    names = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run[0]()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA for _ in range(e.count)]
        if names:
            break
    assert len(names) == ep.KERNELS_PER_CALL["mma"], names
    assert sum("entropy_mma_kernel" in n for n in names) == 1, names
    streams = [torch.cuda.Stream() for _ in run]
    outs = []
    for st, f in zip(streams, run):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(f())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = [f() for f in run]
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for got in (outs, replayed, [f() for f in run]):
        for out, ref in zip(got, refs):
            assert torch.equal(out, ref)


@pytest.mark.parametrize("top", [20, 25, 30])
@pytest.mark.parametrize("dtype", DTYPES)
def test_entropy_kernel_holds_a_peaked_distribution(cuda, top, dtype):
    """Logits of std ~2 but for one column a row at ~``top``: one token
    takes nearly all the mass (entropies of 4e-3 to 3e-7 nats), as at
    gemma-2b's 2-layer float32 forward.  Every variant, W untied and as
    the tied view, within 1e-5 of the float64 entropy of the same logits
    and of the plain version.  With T taken about 0 (H = m + log Z - T / Z,
    the reference's form) the kernel's sums each rounded to an ulp of the
    largest logit: 3.05e-5 off the plain version at gemma-2b."""
    rng = np.random.default_rng(top)
    B, d, Vp, vocab = 8, 256, 20_000, 19_900
    h = _randn(rng, (B, d), dtype, cuda)
    w = _randn(rng, (d, Vp), torch.float32, cuda, scale=2.0 / math.sqrt(d))
    hf = h.float()
    for b, j in enumerate(rng.choice(Vp - 200, size=B, replace=False)):
        w[:, j] = hf[b] * top / float(hf[b] @ hf[b])
    w = w.to(dtype)
    lp = torch.log_softmax((h.double() @ w.double())[:, :vocab], dim=-1)
    truth = (-(lp.exp() * lp).sum(dim=-1)).float()
    assert float(truth.max()) < 1e-2
    ref = ep.next_token_entropy_plain(h, w, vocab)
    torch.testing.assert_close(ref, truth, atol=1e-5, rtol=0)
    for ww in (w, w.t().contiguous().t()):
        variants = ("mma", "scalar") if ep.entropy_variant(h, ww) == "mma" else ("scalar",)
        for variant in variants:
            out = ep.entropy_probe_cuda(h, ww, vocab, variant=variant)
            torch.testing.assert_close(out, truth, atol=1e-5, rtol=0)
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_entropy_uniform_is_log_vocab(cuda):
    out = ep.entropy_probe_cuda(torch.zeros((2, 8), device=cuda),
                                torch.zeros((8, 128), device=cuda), 100)
    torch.testing.assert_close(out, torch.full_like(out, math.log(100)),
                               atol=1e-5, rtol=1e-5)


SSD_CASES = [
    # B, S, nh, hp, G, N, chunk: tests/test_ssm.py's sweep (G < nh, ragged S,
    # chunk 4), mamba2-2.7b's head shapes over a ragged 3-chunk prompt, the
    # main-path prefill (B 4, S 512, 80 heads) and the serve's admissions
    # (B 1, S 512 and a ragged S 300).  Every case but chunk 4 takes the
    # tensor-core variant.
    (1, 16, 2, 8, 1, 8, 8),
    (2, 37, 4, 8, 2, 16, 16),
    (2, 64, 8, 16, 1, 32, 32),
    (1, 20, 6, 8, 3, 8, 4),
    (2, 300, 4, 64, 1, 128, 128),
    (4, 512, 80, 64, 1, 128, 128),
    (1, 512, 80, 64, 1, 128, 128),
    (1, 300, 80, 64, 1, 128, 128),
]


def _ssd_inputs(rng, case, dev, with_h0):
    """Scan inputs shaped as ssm_forward makes them: logd = -dt * (h + 1),
    dt in [1e-3, 1e-1], so the later heads of a wide case decay as steeply
    as mamba2-2.7b's (exp(cs) underflows over a chunk)."""
    B, S, nh, hp, G, N, _ = case
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(B, S, nh)))
    u = f(rng.normal(size=(B, S, nh, hp)) * 0.3)
    logd = f(-dt * np.arange(1, nh + 1))
    Bm = f(rng.normal(size=(B, S, G, N)) * 0.4)
    Cm = f(rng.normal(size=(B, S, G, N)) * 0.4)
    h0 = f(rng.normal(size=(B, nh, N, hp)) * 0.2) if with_h0 else None
    return (u, logd, Bm, Cm), h0


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_kernel_matches_plain(cuda, case, with_h0):
    args, h0 = _ssd_inputs(np.random.default_rng(4), case, cuda, with_h0)
    B, S, nh, hp, G, N, chunk = case
    variant = ss.ssd_variant(chunk, N, hp)
    assert variant == ("scalar" if chunk == 4 else "mma")
    n = ss.ssd_scan_cuda.launches
    before = dict(ss.ssd_scan_cuda.variant_launches)
    y, h = ss.ssd_scan(*args, chunk=chunk, h0=h0)          # auto -> the kernel
    after = ss.ssd_scan_cuda.variant_launches
    assert ss.ssd_scan_cuda.launches == n + 1
    assert {x: after[x] - before[x] for x in after} == \
        {x: int(x == variant) for x in after}
    yr, hr = ss.ssd_scan_plain(*args, chunk=chunk, h0=h0)
    _within_ssd_bar((y, h), (yr, hr))


def _within_ssd_bar(outs, refs):
    """y and h_final each within 1e-5 of the largest magnitude of its
    plain counterpart, finite and of its shape."""
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        err = (out - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.parametrize("case", [SSD_CASES[i] for i in (0, 1, 4, 6)])
def test_ssd_scan_scalar_variant_matches_plain(cuda, case):
    """The scalar kernel, forced at shapes the rule sends to the tensor
    cores, stays within the same bar (chip_smoke.py times it beside the
    mma variant)."""
    args, h0 = _ssd_inputs(np.random.default_rng(5), case, cuda, True)
    chunk = case[-1]
    out = ss.ssd_scan_cuda(*args, chunk=chunk, h0=h0, variant="scalar")
    _within_ssd_bar(out, ss.ssd_scan_plain(*args, chunk=chunk, h0=h0))


@pytest.mark.parametrize("variant", ["mma", "scalar"])
def test_ssd_scan_kernels_per_call(cuda, variant):
    """One op call runs ssd_scan.KERNELS_PER_CALL[variant] kernels on the
    card (the profiler's count), at the admission shape B 1, S 512.  A
    session that reads no device event at all (a short one now and then
    does) is repeated, up to 5 in all, as chip_smoke.py's device_kernels
    does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args, h0 = _ssd_inputs(np.random.default_rng(6), SSD_CASES[6], cuda, True)
    ss.ssd_scan_cuda(*args, chunk=128, h0=h0, variant=variant)
    torch.cuda.synchronize()
    names = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ss.ssd_scan_cuda(*args, chunk=128, h0=h0, variant=variant)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA for _ in range(e.count)]
        if names:
            break
    ours = [n for n in names if "ssd_" in n]
    assert len(ours) == ss.KERNELS_PER_CALL[variant], names


def test_ssd_scan_refuses_bad_inputs(cuda):
    args, _ = _ssd_inputs(np.random.default_rng(0), SSD_CASES[0], cuda, False)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan(*(a.cpu() for a in args), chunk=8, impl="cuda")
    with pytest.raises(TypeError):
        ss.ssd_scan_cuda(args[0].double(), *args[1:], chunk=8)
    with pytest.raises(ValueError):
        ss.ssd_scan_cuda(*args, chunk=256)
    with pytest.raises(ValueError):
        ss.ssd_scan_cuda(*args, chunk=8, h0=torch.zeros((1, 2, 8, 4), device=cuda))
    with pytest.raises(ValueError):                        # chunk 4: no mma tiles
        ss.ssd_scan_cuda(*args, chunk=4, variant="mma")
    shifted = torch.empty(args[0].numel() + 1, device=cuda)[1:].view(args[0].shape)
    with pytest.raises(ValueError, match="aligned"):      # mma copies 16 bytes
        ss.ssd_scan_cuda(shifted, *args[1:], chunk=8)


def test_ssd_scan_mma_keeps_no_state_between_calls(cuda):
    """Two calls of the mma variant at once on two streams, and calls
    replayed from a CUDA graph, each give what an eager call on its own
    gives, bit for bit (at the admission shape B 1, S 512)."""
    rng = np.random.default_rng(7)
    sets = [_ssd_inputs(rng, SSD_CASES[6], cuda, True) for _ in range(2)]
    run = [lambda a=a, h=h: ss.ssd_scan_cuda(*a, chunk=128, h0=h) for a, h in sets]
    refs = [f() for f in run]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in run]
    outs = []
    for st, f in zip(streams, run):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(f())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = [f() for f in run]
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for got in (outs, replayed):
        for out, ref in zip(got, refs):
            assert all(torch.equal(o, r) for o, r in zip(out, ref))


def test_wrappers_refuse_bad_inputs(cuda):
    q = torch.zeros((1, 4, 2, 16), device=cuda)
    pos = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), q.half(), q.half(), pos, pos, scale=1.0)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, q, q, pos.long(), pos, scale=1.0)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, q, q, pos, pos[:, :3].contiguous(), scale=1.0)
    with pytest.raises(ValueError):
        ep.entropy_probe_cuda(torch.zeros((2, 8), device=cuda),
                              torch.zeros((8, 64), device=cuda), 65)


def test_serve_kernels_match_plain_tokens(cuda):
    """The tiny serve on the card: kernel path and plain path give the same
    greedy tokens and exits, and paged == ring bitwise per impl."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.data.synthetic import ChainTask
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = get_config("tiny")
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    b = ChainTask().serve_batch(np.random.default_rng(7), 6)
    runs = {}
    for kind in ("ring", "paged"):
        for impl in ("cuda", "plain"):
            model.attn_impl = impl
            ecfg = EngineConfig(max_reasoning_tokens=24, capacity=256, chunk_len=8,
                                sampler=SamplerConfig(greedy=True),
                                cache=CacheConfig(kind=kind, attn_impl=impl))
            mon = ReasoningMonitor(stopper=EATStopper(delta=1e9),
                                   probe=make_probe(1, (6,)), schedule="every_n",
                                   every_n=4, min_evals=1)
            runs[kind, impl] = ReasoningEngine(model, ecfg, mon).serve(
                b["prompts"], b["prompt_len"], batch_size=4, answer_len=4,
                record_trace=True)
    for impl in ("cuda", "plain"):
        for r, o in zip(runs["ring", impl], runs["paged", impl]):
            np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
            assert r["eat_trace"] == o["eat_trace"]
    for r, o in zip(runs["paged", "cuda"], runs["paged", "plain"]):
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        assert r["exit_reason"] == o["exit_reason"]


def test_ssm_serve_kernel_matches_plain_tokens(cuda):
    """The tiny-ssm ring serve on the card, prompts left-padded past the
    m > 16 scan switch: the scan kernel and the plain scan give the same
    greedy tokens, exits and answers, and the kernel ran in every prefill."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.data.synthetic import ChainTask
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = get_config("tiny-ssm")
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    b = ChainTask().serve_batch(np.random.default_rng(7), 6)
    prompts = np.pad(b["prompts"], ((0, 0), (40 - b["prompts"].shape[1], 0)))
    runs = {}
    for impl in ("cuda", "plain"):
        model.scan_impl = impl
        ecfg = EngineConfig(max_reasoning_tokens=24, capacity=512, chunk_len=8,
                            sampler=SamplerConfig(greedy=True))
        mon = ReasoningMonitor(stopper=EATStopper(delta=1e9),
                               probe=make_probe(1, (6,)), schedule="every_n",
                               every_n=4, min_evals=1)
        n = ss.ssd_scan_cuda.launches
        runs[impl] = ReasoningEngine(model, ecfg, mon).serve(
            prompts, b["prompt_len"], batch_size=4, answer_len=4)
        launched = ss.ssd_scan_cuda.launches - n
        # 2 layers per prefill: the cohort of 4, then 2 admissions of 1
        assert launched == (6 if impl == "cuda" else 0), launched
    for r, o in zip(runs["cuda"], runs["plain"]):
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        np.testing.assert_array_equal(r["answer_tokens"], o["answer_tokens"])
        assert r["exit_reason"] == o["exit_reason"]


def _decode_inputs(rng, dev, dtype, *, B, m, C, Hq, Hkv, Dk, Dv, rotate):
    """A dense cache whose rows hold positions 0..n-1 (n about 90% of C),
    from a random ring offset when ``rotate``; the m queries at the end."""
    q = _randn(rng, (B, m, Hq, Dk), dtype, dev)
    k = _randn(rng, (B, C, Hkv, Dk), dtype, dev)
    v = _randn(rng, (B, C, Hkv, Dv), dtype, dev)
    kv_pos = np.full((B, C), -1, np.int32)
    q_pos = np.zeros((B, m), np.int32)
    for b in range(B):
        n = C - C // 10 - b
        off = int(rng.integers(C)) if rotate else 0
        kv_pos[b, (off + np.arange(n)) % C] = np.arange(n)
        q_pos[b] = np.arange(n - m, n)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return q, k, v, t(q_pos), t(kv_pos)


def _within_decode_bar(out, ref):
    """bf16: |out - ref| <= one bf16 ulp of the larger value + 1e-6
    (chip_smoke.py DECODE_BF16_ATOL), element by element."""
    diff = (out.float() - ref.float()).abs()
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    ratio = (diff / (ulp + 1e-6)).max().item()
    assert ratio <= 1, f"{ratio:.3g} of the bar (1 bf16 ulp + 1e-6)"


@pytest.mark.parametrize("case", [
    # B, m, C, Hq, Hkv, Dk, Dv, window, rotate: the reference's decode sweep
    # shapes (tests/test_kernels_attention.py), then eat-paper-8b's decode
    # and probe widths over a ring-rotated 4096-slot cache
    (2, 1, 70, 8, 2, 64, 32, 0, False),
    (2, 2, 70, 8, 2, 64, 32, 16, False),
    (2, 5, 70, 8, 2, 64, 32, 0, True),
    (2, 5, 70, 8, 2, 64, 32, 16, True),
    (4, 1, 4096, 32, 8, 128, 128, 0, True),
    (4, 2, 4096, 32, 8, 128, 128, 0, True),
    (4, 8, 4096, 32, 8, 128, 128, 0, True),
    (4, 1, 4096, 32, 8, 128, 128, 1024, True),
    (1, 8, 1000, 64, 8, 96, 64, 0, True),         # 64 rows, Dv != Dk
    (2, 5, 1000, 16, 4, 128, 128, 0, True),       # 20 rows: two m-tiles
    (1, 6, 1000, 64, 8, 128, 128, 0, True),       # 48 rows: one warp idle
    (2, 2, 300, 8, 2, 80, 80, 0, True),           # bf16 on the scalar kernel
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(cuda, case, dtype):
    B, m, C, Hq, Hkv, Dk, Dv, window, rotate = case
    args = _decode_inputs(np.random.default_rng(5), cuda, dtype, B=B, m=m, C=C,
                          Hq=Hq, Hkv=Hkv, Dk=Dk, Dv=Dv, rotate=rotate)
    variant = da.decode_variant(dtype, Dk, Dv)
    n = da.decode_attention_cuda.launches
    before = dict(da.decode_attention_cuda.variant_launches)
    out = da.decode_attention(*args, window=window)           # auto -> kernel
    after = da.decode_attention_cuda.variant_launches
    assert da.decode_attention_cuda.launches == n + 1
    assert {x: after[x] - before[x] for x in after} == \
        {x: int(x == variant) for x in after}
    ref = da.decode_attention_plain(*args, window=window, scale=1.0 / math.sqrt(Dk))
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    if dtype == torch.bfloat16:
        _within_decode_bar(out, ref)
    else:
        tol = _tol(dtype)
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


def test_decode_kernel_empty_rows_and_splits(cuda):
    """A row with no valid key gives exactly 0; a narrow window leaves most
    splits of a long cache without a valid key, each an identity in the
    merge."""
    q, k, v, qp, kp = _decode_inputs(np.random.default_rng(6), cuda, torch.float32,
                                     B=3, m=2, C=4096, Hq=8, Hkv=2, Dk=64, Dv=64,
                                     rotate=True)
    kp[0] = -1
    out = da.decode_attention_cuda(q, k, v, qp, kp, window=40, scale=0.125)
    ref = da.decode_attention_plain(q, k, v, qp, kp, window=40, scale=0.125)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_decode_wrapper_refuses_bad_inputs(cuda):
    def inputs(m=1, Hq=4, Hkv=2, D=64, dtype=torch.float32):
        return _decode_inputs(np.random.default_rng(0), cuda, dtype, B=1, m=m,
                              C=32, Hq=Hq, Hkv=Hkv, Dk=D, Dv=D, rotate=False)

    kw = dict(scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(*(a.cpu() for a in inputs()), impl="cuda")
    with pytest.raises(TypeError):
        da.decode_attention_cuda(*inputs(dtype=torch.float16), **kw)
    with pytest.raises(ValueError):                        # head dim above 256
        da.decode_attention_cuda(*inputs(D=288), **kw)
    with pytest.raises(ValueError):                        # 9 * 8 = 72 rows
        da.decode_attention_cuda(*inputs(m=9, Hq=16, Hkv=2), **kw)
    with pytest.raises(ValueError):                        # Hq % Hkv
        da.decode_attention_cuda(*inputs(Hq=6, Hkv=4), **kw)
    q, k, v, qp, kp = inputs()
    with pytest.raises(ValueError):                        # a strided cache
        da.decode_attention_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                                 v, qp, kp, **kw)


def test_proxy_serve_kernels_match_plain_tokens(cuda):
    """The tiny generator monitored by tiny-proxy on the card, paged: the
    kernel path and the plain path give the same greedy tokens, exits and
    answers, the proxy stops some request, and the generator never
    probes."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.data.synthetic import ChainTask
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.proxy import ProxyConfig
    from repro_torch.serving.sampler import SamplerConfig

    def build(arch, seed):
        cfg = get_config(arch)
        return Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(seed),
                                      device=cuda))

    model, proxy = build("tiny", 3), build("tiny-proxy", 4)
    b = ChainTask().serve_batch(np.random.default_rng(7), 6)
    runs = {}
    for impl in ("cuda", "plain"):
        model.attn_impl = proxy.attn_impl = impl
        ecfg = EngineConfig(max_reasoning_tokens=24, capacity=256, chunk_len=8,
                            sampler=SamplerConfig(greedy=True),
                            cache=CacheConfig(kind="paged", attn_impl=impl))
        mon = ReasoningMonitor(stopper=EATStopper(delta=1e9), probe=make_probe(1, (6,)),
                               schedule="every_n", every_n=4, min_evals=1)
        eng = ReasoningEngine(model, ecfg, mon, proxy=ProxyConfig(model=proxy))
        probes = []
        fn = eng.model.probe_entropy

        def counted(*a, _fn=fn, _probes=probes, **kw):
            _probes.append(1)
            return _fn(*a, **kw)

        eng.model.probe_entropy = counted
        runs[impl] = eng.serve(b["prompts"], b["prompt_len"], batch_size=4,
                               answer_len=4)
        assert not probes
    for r, o in zip(runs["cuda"], runs["plain"]):
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        np.testing.assert_array_equal(r["answer_tokens"], o["answer_tokens"])
        assert r["exit_reason"] == o["exit_reason"]
    assert "eat" in [r["exit_reason"] for r in runs["cuda"]]


# ------------------------------------------------------------ the device loop


def test_graph_conditional_node_api(cuda):
    """What a chunk the device runs alone needs from torch: ``CUDAGraph``
    records if-nodes on a device bool (nested two deep here) and registers
    a generator, so a replay skips a body whose predicate is false and a
    draw inside a body is fresh on every replay: what the lazy probe of a
    chunk graph needs (route (b) of ROADMAP queue 1 item 2; the chunk
    graphs of route (a) run every probe, with no if-node).  Skipped, with
    the missing methods named, on a torch whose CUDAGraph lacks them (torch
    2.11.0+cu128 on the H100, as PERF.md records)."""
    missing = [name for name in ("begin_capture_to_if_node",
                                 "end_capture_to_conditional_node",
                                 "register_generator_state")
               if not hasattr(torch.cuda.CUDAGraph, name)]
    if missing:
        pytest.skip(f"torch {torch.__version__}: CUDAGraph has no "
                    f"{', '.join(missing)}: a chunk graph's lazy probe "
                    f"(route (b)) needs if-nodes built by the port")
    gen = torch.Generator(cuda).manual_seed(0)
    outer = torch.zeros((), dtype=torch.bool, device=cuda)
    x = torch.zeros((), dtype=torch.int64, device=cuda)
    hits = torch.zeros(3, dtype=torch.int64, device=cuda)
    draws = torch.zeros(3, dtype=torch.int64, device=cuda)
    probs = torch.ones((1, 1000), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.multinomial(probs, 1, generator=gen)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    with torch.cuda.graph(g):
        for i in range(3):
            g.begin_capture_to_if_node(outer)
            x.add_(1)
            g.begin_capture_to_if_node(x >= 2)
            hits[i].add_(1)
            draws[i].copy_(torch.multinomial(probs, 1, generator=gen)[0, 0])
            g.end_capture_to_conditional_node()
            g.end_capture_to_conditional_node()
    g.replay()
    torch.cuda.synchronize()
    assert int(x) == 0 and hits.tolist() == [0, 0, 0]
    outer.fill_(True)
    g.replay()
    first = draws.clone()
    torch.cuda.synchronize()
    assert int(x) == 3 and hits.tolist() == [0, 1, 1]
    g.replay()
    torch.cuda.synchronize()
    assert int(x) == 6 and hits.tolist() == [1, 2, 2]
    assert not torch.equal(draws[1:], first[1:])


@pytest.mark.parametrize("kind,proxy", [("ring", False), ("paged", False),
                                        ("paged", True)])
def test_chunk_syncs_the_host_only_in_device_if(cuda, monkeypatch, kind, proxy):
    """On the card, with every ``device_if`` taking its then-branch without
    reading its predicate, an eager decode chunk with a probe at every step
    (and, with the proxy, an eager shadow chunk) runs under sync debug mode
    "error": the predicate reads are the only host syncs in an eager chunk
    (no value read, no host-to-device copy that waits)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import monitor as monitor_mod
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving import executor as executor_mod
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.proxy import ProxyConfig
    from repro_torch.serving.sampler import SamplerConfig

    cfg = get_config("tiny")
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    ecfg = EngineConfig(max_reasoning_tokens=24, capacity=256, chunk_len=4,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind=kind, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=0.0), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=1, min_evals=1)
    eng = ReasoningEngine(model, ecfg, mon,
                          proxy=ProxyConfig(model=model) if proxy else None)
    rng = np.random.default_rng(7)
    prompts = rng.integers(16, cfg.vocab, (4, 20))
    ss = eng._serve_setup(prompts, np.full(4, 20), None, batch_size=4,
                          max_tokens=24, chunk_len=4)

    def strict(fn, *a, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def chunk(state, run):
        """One chunk, its page mapping first (host work between chunks)."""
        if kind == "paged":
            state = eng.executor.ensure_chunk_pages(ss.alloc, state,
                                                    [0, 1, 2, 3], 8, cur=int(state.cache["cur"]))
        gen = run(eng.executor.decode_chunk, state, 24, 4,
                  use_monitor=not proxy, eager=True)
        if proxy:
            ss.ptier.begin_chunk(4, [0, 1, 2, 3])
            ss.ptier.state = run(eng.proxy_executor.observe_chunk,
                                 ss.ptier.state, gen.out_tokens, state.out_len,
                                 gen.out_len - state.out_len, 4, eager=True)
        return gen

    # the first chunk eagerly, as it comes: every kernel loaded
    state = chunk(ss.state, lambda fn, *a, **kw: fn(*a, **kw))
    taken = lambda pred, then_fn, else_fn=None: then_fn()  # noqa: E731
    monkeypatch.setattr(executor_mod, "device_if", taken)
    monkeypatch.setattr(monitor_mod, "device_if", taken)
    state = chunk(state, strict)
    assert int(state.out_len.max()) == 1 + 2 * 4


# ------------------------------------------------------ the chunk graphs


def _graph_engine(cuda, arch="tiny", *, kind="ring", proxy=None, greedy=True,
                  delta=1e9, every_n=3, min_evals=2, budget=24, chunk=8):
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.proxy import ProxyConfig
    from repro_torch.serving.sampler import SamplerConfig

    cfg = get_config(arch)
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    ecfg = EngineConfig(max_reasoning_tokens=budget, capacity=256, chunk_len=chunk,
                        sampler=SamplerConfig(greedy=greedy),
                        cache=CacheConfig(kind=kind, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=delta), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=every_n, min_evals=min_evals)
    return ReasoningEngine(model, ecfg, mon, proxy=None if proxy is None else
                           ProxyConfig(model=model if proxy == "self" else proxy))


def _graph_setup(eng, n=4, S=20, seed=7):
    prompts = np.random.default_rng(seed).integers(16, eng.model.cfg.vocab, (n, S))
    return eng._serve_setup(prompts, np.full(n, S), None, batch_size=n,
                            max_tokens=eng.ecfg.max_reasoning_tokens,
                            chunk_len=eng.ecfg.chunk_len)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _clone_state(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_state(v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_state(v) for v in tree))
    return tree


def _assert_same_state(a, b):
    la, lb = _tensors(a), _tensors(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch,kind,proxy", [
    ("tiny", "ring", None), ("tiny", "paged", None), ("tiny-ssm", "ring", None),
    ("tiny", "ring", "self"), ("tiny", "paged", "self")])
def test_chunk_graph_equals_the_eager_chunk(cuda, arch, kind, proxy):
    """Two chunks (the first captures, the second replays), each against
    the eager guarded chunk from a copy of the same state: the state and the
    whole cache bitwise.  With the proxy, the generator chunk runs eagerly
    and the proxy's shadow chunk is the one compared."""
    eng = _graph_engine(cuda, arch, kind=kind, proxy=proxy)
    ss = _graph_setup(eng)
    state = ss.state
    for _ in range(2):
        if ss.paged:
            state = eng.executor.ensure_chunk_pages(ss.alloc, state, [0, 1, 2, 3],
                                                    ss.chunk + 2, cur=int(state.cache["cur"]))
        if proxy is None:
            ref = eng.executor.decode_chunk(_clone_state(state), ss.budget, ss.chunk,
                                            eager=True)
            state = eng.executor.decode_chunk(state, ss.budget, ss.chunk)
            _assert_same_state(ref, state)
            continue
        gen = eng.executor.decode_chunk(state, ss.budget, ss.chunk,
                                        use_monitor=False, eager=True)
        ss.ptier.begin_chunk(ss.chunk, [0, 1, 2, 3])
        args = (gen.out_tokens, state.out_len, gen.out_len - state.out_len, ss.chunk)
        px = eng.proxy_executor
        ref = px.observe_chunk(_clone_state(ss.ptier.state), *args, eager=True)
        ss.ptier.state = px.observe_chunk(ss.ptier.state, *args)
        _assert_same_state(ref, ss.ptier.state)
        state = gen
    graphs = (eng.executor if proxy is None else eng.proxy_executor).graphs
    assert graphs.captures == 1 and graphs.replays == 2


@pytest.mark.parametrize("arch,kind,proxy", [("tiny", "paged", None),
                                             ("tiny", "paged", "self"),
                                             ("tiny-ssm", "ring", None)])
def test_second_serve_makes_no_capture(cuda, arch, kind, proxy):
    """A serve on the graphs, a second serve of the same engine (no capture,
    every chunk a replay) and an eager serve of it give the same tokens,
    exits, answers and EAT traces."""
    eng = _graph_engine(cuda, arch, kind=kind, proxy=proxy)
    b = np.random.default_rng(5).integers(16, eng.model.cfg.vocab, (6, 24))
    lens = np.array([24, 20, 17, 24, 9, 12])

    def serve(**kw):
        return eng.serve(b, lens, None, batch_size=4, answer_len=2,
                         record_trace=True, **kw)

    runs = [serve()]
    tiers = [eng.executor] + ([eng.proxy_executor] if proxy else [])
    captures = [ex.graphs.captures for ex in tiers]
    replays = [ex.graphs.replays for ex in tiers]
    runs += [serve(), serve(eager=True)]
    assert all(c > 0 for c in captures)
    assert [ex.graphs.captures for ex in tiers] == captures
    assert all(ex.graphs.replays > r for ex, r in zip(tiers, replays))
    assert "eat" in [r["exit_reason"] for r in runs[0]]
    for other in runs[1:]:
        for a, o in zip(runs[0], other):
            assert a["eat_trace"] == o["eat_trace"] and a["slot"] == o["slot"]
            np.testing.assert_array_equal(a["reasoning_tokens"], o["reasoning_tokens"])
            np.testing.assert_array_equal(a["answer_tokens"], o["answer_tokens"])


@pytest.mark.parametrize("proxy", [None, "self"])
def test_chunk_graph_replay_makes_no_host_sync(cuda, proxy):
    """After its capture, a chunk (and a shadow chunk) replays under sync
    debug mode "error": no host sync and no device_if read inside it."""
    from repro_torch.serving import device_loop

    eng = _graph_engine(cuda, kind="paged", proxy=proxy, delta=0.0, every_n=1,
                        min_evals=1, chunk=4)
    ss = _graph_setup(eng)

    def chunk(state, strict):
        state = eng.executor.ensure_chunk_pages(ss.alloc, state, [0, 1, 2, 3], 8, cur=int(state.cache["cur"]))
        if proxy:
            ss.ptier.begin_chunk(4, [0, 1, 2, 3])
        n_start = state.out_len.clone()
        torch.cuda.synchronize()
        calls = device_loop.device_if.calls
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            gen = eng.executor.decode_chunk(state, 24, 4, use_monitor=not proxy)
            if proxy:
                ss.ptier.state = eng.proxy_executor.observe_chunk(
                    ss.ptier.state, gen.out_tokens, n_start, gen.out_len - n_start, 4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert device_loop.device_if.calls == calls
        return gen

    state = chunk(ss.state, strict=False)          # captures
    state = chunk(state, strict=True)
    assert int(state.out_len.max()) == 1 + 2 * 4


def test_sampled_chunk_graph_equals_the_eager_chunk(cuda):
    """Temperature sampling with the state's own generator, every row
    exiting by EAT inside the chunk (step 5 of 8): the replay draws on all
    8 steps from the graph's generator, started from the state's; its state
    equals the eager masked chunk's and the eager guarded chunk's (which
    stops after 5 steps), and once the snapshot has read the step count the
    state's generator stands where the guarded chunk left it."""
    eng = _graph_engine(cuda, kind="paged", greedy=False)
    rng = torch.Generator(cuda).manual_seed(11)
    prompts = np.random.default_rng(7).integers(16, eng.model.cfg.vocab, (4, 20))
    ss = eng._serve_setup(prompts, np.full(4, 20), rng, batch_size=4,
                          max_tokens=24, chunk_len=8)
    ex = eng.executor
    state = ex.ensure_chunk_pages(ss.alloc, ss.state, [0, 1, 2, 3], 10, cur=int(ss.state.cache["cur"]))
    seed = rng.get_state()
    masked = ex.masked_chunk(_clone_state(state), 24, 8)
    rng.set_state(seed)
    guarded = ex.decode_chunk(_clone_state(state), 24, 8, eager=True)
    after_guarded = rng.get_state()
    rng.set_state(seed)
    state = ex.decode_chunk(state, 24, 8)
    snap = ex.snapshot(state)
    assert 0 < snap.steps < 8 and not snap.active.any()
    assert not torch.equal(after_guarded, seed)
    assert torch.equal(rng.get_state(), after_guarded)
    _assert_same_state(masked, state)
    _assert_same_state(guarded, state)
    assert ex.graphs.captures == 1


def test_sampled_serves_with_fresh_generators_equal_the_eager_serves(cuda):
    """Two sampled serves of one engine, each with its own freshly seeded
    generator (rows exit inside chunks, admissions sample their first token
    between chunks): each equals the eager serve from the same seed, the two
    seeds give different streams, and the second serve captures nothing."""
    eng = _graph_engine(cuda, kind="paged", greedy=False)
    b = np.random.default_rng(5).integers(16, eng.model.cfg.vocab, (6, 24))
    lens = np.array([24, 20, 17, 24, 9, 12])
    runs, captures = [], []
    for seed in (11, 12):
        def serve(**kw):
            return eng.serve(b, lens, torch.Generator(cuda).manual_seed(seed),
                             batch_size=4, answer_len=2, record_trace=True, **kw)

        graph = serve()
        captures.append(eng.executor.graphs.captures)
        eager = serve(eager=True)
        assert "eat" in [r["exit_reason"] for r in graph]
        assert any(r["n_reasoning"] % 8 for r in graph)
        for a, o in zip(graph, eager):
            assert a["eat_trace"] == o["eat_trace"] and a["slot"] == o["slot"]
            np.testing.assert_array_equal(a["reasoning_tokens"], o["reasoning_tokens"])
            np.testing.assert_array_equal(a["answer_tokens"], o["answer_tokens"])
        runs.append(graph)
    assert captures[0] > 0 and captures[1] == captures[0]
    assert any(not np.array_equal(a["reasoning_tokens"], o["reasoning_tokens"])
               for a, o in zip(*runs))


def test_chunk_graph_launch_counts_match_the_profiler(cuda):
    """Over a warm serve (every chunk a replay), the wrappers' counts
    (eager calls, plus each graph's captured calls once per replay) equal
    the kernels the profiler sees: three paged kernels per op call, two
    entropy kernels per call, one flash kernel per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = _graph_engine(cuda, kind="paged")
    b = np.random.default_rng(5).integers(16, eng.model.cfg.vocab, (6, 24))
    lens = np.full(6, 24)
    eng.serve(b, lens, None, batch_size=4, answer_len=2)
    captures = eng.executor.graphs.captures
    for fn in (fa.flash_attention_cuda, pa.paged_attention_cuda, ep.entropy_probe_cuda):
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.serve(b, lens, None, batch_size=4, answer_len=2)
        torch.cuda.synchronize()
    assert eng.executor.graphs.captures == captures
    seen = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.removeprefix("void ").removeprefix("(anonymous namespace)::")
            name = name.split("<")[0].split("(")[0]
            seen[name] = seen.get(name, 0) + e.count
    paged = pa.paged_attention_cuda.launches
    assert paged > 0 and ep.entropy_probe_cuda.launches > 0
    for kernel in ("paged_max_kernel", "paged_fold_kernel", "paged_merge_kernel"):
        assert seen.get(kernel, 0) == paged, (kernel, seen)
    assert seen.get("merge_kernel", 0) == ep.entropy_probe_cuda.launches
    flash = sum(seen.get(k, 0) for k in ("flash_kernel", "flash_mma_kernel"))
    assert flash == fa.flash_attention_cuda.launches


def test_chunk_graph_survives_a_bucket_width_round_trip(cuda):
    """The page list goes from bucket width W to W + 4 and back to W
    between chunks: the graph of W replays on the same buffers after the
    round trip (no third capture), and each chunk equals the eager chunk."""
    eng = _graph_engine(cuda, kind="paged", delta=0.0, budget=64)
    ss = _graph_setup(eng)
    ex, alloc = eng.executor, ss.alloc
    state = ex.ensure_chunk_pages(alloc, ss.state, [0, 1, 2, 3], 64 + 2, cur=int(ss.state.cache["cur"]))
    width = alloc.bucket_width()
    for extra in (0, 4, 0):
        pages, logical, counts = alloc.block_buckets(width + extra)
        state = ex.put_page_table(state, alloc.table, (pages, logical, counts))
        ref = ex.decode_chunk(_clone_state(state), 64, 8, eager=True)
        state = ex.decode_chunk(state, 64, 8)
        _assert_same_state(ref, state)
    assert ex.graphs.captures == 2 and ex.graphs.replays == 3


# ------------------------------------------------------ the rollout graphs


def _rollout_setup(cuda, kind, greedy_engine=True):
    eng = _graph_engine(cuda, kind=kind, greedy=greedy_engine)
    ss = _graph_setup(eng)
    state = ss.state
    if ss.paged:
        state = eng.executor.ensure_chunk_pages(ss.alloc, state, [0, 1, 2, 3], 6, cur=int(state.cache["cur"]))
    return eng, state


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("greedy", [True, False])
def test_rollout_graph_equals_the_eager_rollout(cuda, kind, greedy):
    """A forced-answer rollout of 5 tokens as a graph replay (the first call
    captures, the second replays) against the eager loop from the same
    generator state: tokens and log-probs bitwise, the caller's generator
    at the same offset afterwards, and the whole cache (its live slots,
    ``pos``, ``cur``) as it was."""
    eng, state = _rollout_setup(cuda, kind)
    ex = eng.executor
    before = _clone_state(state.cache)
    rng = torch.Generator(cuda).manual_seed(11)
    seed = rng.get_state()
    ref = ex.rollout(state.cache, state.next_pos, rng, n=5, greedy=greedy, eager=True)
    after = rng.get_state()
    assert greedy == torch.equal(after, seed)
    _assert_same_state(before, state.cache)
    for _ in range(2):
        rng.set_state(seed)
        got = ex.rollout(state.cache, state.next_pos, rng, n=5, greedy=greedy)
        _assert_same_state(ref, got)
        assert torch.equal(rng.get_state(), after)
        _assert_same_state(before, state.cache)
    assert ex.graphs.captures == 1 and ex.graphs.replays == 2


def test_rollout_graphs_key_and_refuse_another_cache(cuda):
    """One graph per (n, greedy) on the kept cache: a second call of each
    captures nothing, K sampled rollouts from one generator replay K times
    and move it as K eager rollouts do, and a cache the executor did not
    allocate raises (no eager fallback)."""
    from repro_torch.serving.cache import alloc_cache

    eng, state = _rollout_setup(cuda, "ring")
    ex = eng.executor
    for _ in range(2):
        for n, greedy in ((4, True), (4, False), (2, False)):
            ex.rollout(state.cache, state.next_pos, None, n=n, greedy=greedy)
    assert ex.graphs.captures == 3 and ex.graphs.replays == 6
    rng = torch.Generator(cuda).manual_seed(4)
    seed = rng.get_state()
    eager = eng.rollout_answers(state, 3, 4, rng, eager=True)
    after = rng.get_state()
    rng.set_state(seed)
    got = eng.rollout_answers(state, 3, 4, rng)
    assert torch.equal(got, eager) and torch.equal(rng.get_state(), after)
    assert not torch.equal(got[0], got[1])
    assert ex.graphs.captures == 3 and ex.graphs.replays == 9
    other = alloc_cache(eng.model.cfg, 4, state.cache["pos"].shape[1], device=cuda)
    other["cur"].copy_(state.cache["cur"])
    with pytest.raises(RuntimeError, match="not the one it captured"):
        ex.rollout(other, state.next_pos, None, n=4, greedy=True)


def test_warm_graph_trace_equals_the_eager_trace(cuda):
    """``reason_with_trace`` with a sampled chain, K 2 sampled rollouts and a
    3-token greedy confidence per point: a cold graph trace (captures), a
    warm one (none; every chunk and rollout a replay) and an eager one give
    the same records bitwise and the same ``out_tokens``, and leave the
    chain's and the rollouts' generators at the same offsets."""
    eng = _graph_engine(cuda, greedy=False, every_n=4, budget=16)
    prompts = np.random.default_rng(7).integers(16, eng.model.cfg.vocab, (4, 20))
    graphs = eng.executor.graphs

    def trace(**kw):
        rng = torch.Generator(cuda).manual_seed(5)
        rr = torch.Generator(cuda).manual_seed(6)
        st = eng.start(prompts, np.full(4, 20), rng)
        c0, r0 = graphs.captures, graphs.replays
        st, tr = eng.reason_with_trace(st, max_tokens=16, rollout_k=2,
                                       rollout_len=3, confidence_len=3,
                                       answer_extract=lambda r: r[:, 0],
                                       rollout_rng=rr, **kw)
        return (tr, st.out_tokens.cpu(), graphs.captures - c0,
                graphs.replays - r0, rng.get_state(), rr.get_state())

    runs = [trace(), trace(), trace(eager=True)]
    n_rec = len(runs[1][0])
    assert runs[0][2] == 3 and runs[1][2] == 0 and runs[2][2] == 0
    # one replay per chunk (at most 4: 15 tokens, 4 a chunk) and 3 per record
    assert n_rec <= runs[1][3] - 3 * n_rec <= 4 and runs[2][3] == 0
    for other in (runs[0], runs[2]):
        tr, toks = other[0], other[1]
        assert len(tr) == n_rec >= 1
        for a, b in zip(runs[1][0], tr):
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        assert torch.equal(runs[1][1], toks)
        assert torch.equal(runs[1][4], other[4]) and torch.equal(runs[1][5], other[5])
