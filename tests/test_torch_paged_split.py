"""The paged kernel's split of the KV axis, on the CPU.

``csrc/paged_attention.cu`` splits each row's keys at logical-block
boundaries (``ops.split_plan``): split s holds the mapped ranks whose
logical block lies in [s·K, (s+1)·K).  A first pass takes each split's row
max; the fold starts split s from the max over the earlier splits (so each
probability rounds against the running max over every earlier page, as in
the sequential scan); the merge adds the float32 partials in split order.
No card here, so ``_emulate`` runs that order in torch on the package's
``softmax_block_step``, and the tests check the contract the kernel rests
on: the paged call (mapped blocks only) and the ring call (every logical
block) give bitwise equal results under it, and it stays within the
reference's bars.  Tolerances: 2e-5 in float32 (the bar of the reference's
attention tests), ``BF16_TOL`` = 3e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jpa
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.data.synthetic import ChainTask
from repro_torch.kernels.flash_attention.ops import (
    softmax_block_step,
    softmax_finish,
    softmax_init,
)
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.launch import serve as launcher
from repro_torch.models.model import Model, init_params
from repro_torch.serving.cache import CacheConfig, page_align
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.sampler import SamplerConfig

BF16_TOL = 3e-2
NEG_INF = -1e30
# tests/test_torch_ops.py's layout (logical blocks per row, holes that empty
# whole splits) plus a row with nothing mapped
HOLES = [[0, 1, 2, 12], [0, 1, 2, 3, 4, 5], [0, 12, 13],
         [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], []]
PS, NB = 16, 16


def _case(*, m, Hq, Hkv, D=16, seed=0):
    """A garbage-filled pool with the rows' mapped pages and the dense ring
    holding the same written values (a numpy copy of test_torch_ops'
    builder, with the empty row)."""
    rng = np.random.default_rng(seed)
    B, C = len(HOLES), NB * PS
    kd = np.zeros((B, C, Hkv, D), np.float32)
    vd = np.zeros((B, C, Hkv, D), np.float32)
    kv_pos = np.full((B, C), -1, np.int32)
    P = sum(len(bl) for bl in HOLES) + 4
    kp = rng.normal(size=(P, PS, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, PS, Hkv, D)).astype(np.float32)
    NBK = max(len(bl) for bl in HOLES) + 2
    pages = np.zeros((B, NBK), np.int32)
    logical = np.zeros((B, NBK), np.int32)
    counts = np.array([len(bl) for bl in HOLES], np.int32)
    nxt = 1
    for b, blocks in enumerate(HOLES):
        for r, blk in enumerate(blocks):
            pages[b, r], logical[b, r] = nxt, blk
            fill = PS if blk != blocks[-1] else PS // 2 + 1
            vk = rng.normal(size=(fill, Hkv, D)).astype(np.float32)
            vv = rng.normal(size=(fill, Hkv, D)).astype(np.float32)
            kp[nxt, :fill], vp[nxt, :fill] = vk, vv
            kd[b, blk * PS:blk * PS + fill] = vk
            vd[b, blk * PS:blk * PS + fill] = vv
            kv_pos[b, blk * PS:blk * PS + fill] = np.arange(blk * PS, blk * PS + fill)
            nxt += 1
    q = rng.normal(size=(B, m, Hq, D)).astype(np.float32)
    q_pos = np.stack([np.arange(C - m, C)] * B).astype(np.int32)
    bpos = pa.block_positions(torch.from_numpy(kv_pos), torch.from_numpy(pages),
                              torch.from_numpy(logical), PS).numpy()
    return dict(q=q, q_pos=q_pos, kd=kd, vd=vd, kv_pos=kv_pos, kp=kp, vp=vp,
                pages=pages, logical=logical, counts=counts, bpos=bpos)


def _ring_inputs(c):
    """The ring call's page list: the dense cache as a pool read through the
    identity list, every logical block at its own rank."""
    B, C = c["kv_pos"].shape
    nb = C // PS
    kp = c["kd"].reshape(B * nb, PS, *c["kd"].shape[2:])
    vp = c["vd"].reshape(B * nb, PS, *c["vd"].shape[2:])
    ranks = np.arange(nb, dtype=np.int32)
    return dict(kp=kp, vp=vp, pages=np.arange(B, dtype=np.int32)[:, None] * nb + ranks,
                logical=np.broadcast_to(ranks, (B, nb)).copy(),
                counts=np.full(B, nb, np.int32),
                bpos=c["kv_pos"].reshape(B, nb, PS))


def _emulate(q, kp, vp, pages, counts, bpos, q_pos, logical, *, K, n_split,
             scale, window=0):
    """The kernel's order in torch: per row, each split's pages folded in
    rank order (the max pass from -1e30, the fold from the earlier splits'
    max), then the partials merged in split order."""
    B, m, Hq, Dk = q.shape
    Hkv, Dv = kp.shape[2], vp.shape[-1]
    g = Hq // Hkv
    qs = q * torch.tensor(scale, dtype=q.dtype)
    qf = qs.float().reshape(B, m, Hkv, g, Dk)
    qp = q_pos[:, None, None, :, None]
    rows = []
    for b in range(B):
        def fold(carry, s):
            for j in range(int(counts[b])):
                if s * K <= int(logical[b, j]) < (s + 1) * K:
                    pg = int(pages[b, j])
                    carry = softmax_block_step(
                        carry, qf[b:b + 1], kp[pg][None], vp[pg][None],
                        qp[b:b + 1], bpos[b, j][None, None, None, None, :],
                        causal=True, window=window)
            return carry

        split_max = [fold(softmax_init(1, Hkv, g, m, Dv, q.device), s)[0]
                     for s in range(n_split)]
        parts, run = [], torch.full_like(split_max[0], NEG_INF)
        for s in range(n_split):
            _, l0, a0 = softmax_init(1, Hkv, g, m, Dv, q.device)
            parts.append(fold((run, l0, a0), s))
            run = torch.maximum(run, split_max[s])
        M = torch.stack([p[0] for p in parts]).amax(0)
        l_tot = torch.zeros_like(M)
        acc = torch.zeros_like(parts[0][2])
        for m_s, l_s, a_s in parts:
            w = torch.exp(m_s - M)
            l_tot = l_tot + w * l_s
            acc = acc + w[..., None] * a_s
        rows.append(softmax_finish((M, l_tot, acc), q.dtype))
    return torch.cat(rows)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


RULE_K = pa.split_plan(PS, NB)[0]


@pytest.mark.parametrize("K", sorted({1, 2, RULE_K}))
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_paged_equals_ring_and_matches_jax(K, window, dtype):
    """Paged == ring bitwise under the kernel's split order, and within
    the bars of the reference's paged_decode_attention, XLA and Pallas
    (interpret mode).  Row 4 maps nothing: its output is exactly 0."""
    c = _case(m=2, Hq=4, Hkv=2)
    td, jd = getattr(torch, dtype), jnp.dtype(dtype)
    q, qp = _t(c["q"], td), torch.from_numpy(c["q_pos"])
    n_split = -(-NB // K)
    kw = dict(K=K, n_split=n_split, scale=0.25, window=window)
    t = torch.from_numpy
    paged = _emulate(q, _t(c["kp"], td), _t(c["vp"], td), t(c["pages"]),
                     t(c["counts"]), t(c["bpos"]), qp, t(c["logical"]), **kw)
    r = _ring_inputs(c)
    ring = _emulate(q, _t(r["kp"], td), _t(r["vp"], td), t(r["pages"]),
                    t(r["counts"]), t(r["bpos"]), qp, t(r["logical"]), **kw)
    assert torch.equal(paged, ring)
    assert torch.equal(paged[4], torch.zeros_like(paged[4]))
    tol = 2e-5 if dtype == "float32" else BF16_TOL
    for impl in ("xla", "pallas"):
        ref = jpa.paged_decode_attention(
            jnp.asarray(c["q"], jd), jnp.asarray(c["kp"], jd),
            jnp.asarray(c["vp"], jd), jnp.asarray(c["pages"]),
            jnp.asarray(c["counts"]), jnp.asarray(c["bpos"]),
            jnp.asarray(c["q_pos"]), window=window, scale=0.25, impl=impl,
            interpret=True)
        np.testing.assert_allclose(paged.float().numpy(),
                                   np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_rounds_like_the_sequential_scan(dtype):
    """Starting each split from the earlier splits' max keeps every
    probability's rounding point: the emulation lands on the plain scan
    within float32 summation noise, in bfloat16 too."""
    c = _case(m=1, Hq=8, Hkv=2, D=32, seed=3)
    td = getattr(torch, dtype)
    t = torch.from_numpy
    args = (_t(c["q"], td), _t(c["kp"], td), _t(c["vp"], td), t(c["pages"]),
            t(c["counts"]), t(c["bpos"]), t(c["q_pos"]))
    out = _emulate(*args, t(c["logical"]), K=2, n_split=NB // 2, scale=0.2)
    ref = pa.paged_attention_plain(*args, scale=0.2)
    diff = (out.float() - ref.float()).abs()
    if dtype == "float32":
        assert diff.max().item() <= 1e-6
    else:   # one bf16 ulp of the larger output, element by element
        big = torch.maximum(out.float().abs(), ref.float().abs())
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
        assert bool((diff <= ulp).all())


@pytest.mark.parametrize("ps,capacity", [(16, 256), (16, 200), (4, 90), (64, 130)])
def test_split_rule_is_shared_by_ring_and_paged(ps, capacity):
    """The rule sees only the page size and the logical capacity: the
    ring call (C slots, padded to a page multiple) and the paged cache of
    the same capacity (page-aligned) get the same K, the same n_split and
    so the same split of every logical block."""
    nb_ring = -(-capacity // ps)
    nb_paged = page_align(capacity, ps) // ps
    K, n = pa.split_plan(ps, nb_ring)
    assert (K, n) == pa.split_plan(ps, nb_paged)
    assert K == max(1, pa.SPLIT_TOKENS // ps) and n * K >= nb_ring > (n - 1) * K
    for lb in range(nb_ring):
        assert lb // K < n


def test_ring_and_paged_serves_pass_the_same_split_inputs(monkeypatch):
    """Through the serving stack: a tiny greedy serve at a capacity that
    is not a page multiple, ring and paged, every paged-attention call
    recorded.  Both callers pass the logical block of each rank and the
    same logical capacity, so split_plan gives them the same K and
    n_split; the paged list ascends in logical block below that capacity;
    and the two serves give the same tokens."""
    calls = {"ring": [], "paged": []}
    kind = ["ring"]
    plain = pa.paged_attention_plain

    def record(q, k_pool, v_pool, pages, counts, bpos, q_pos, **kw):
        calls[kind[0]].append((k_pool.shape[1], kw["logical"].clone(),
                               counts.clone(), kw["num_blocks"]))
        return plain(q, k_pool, v_pool, pages, counts, bpos, q_pos, **kw)

    monkeypatch.setattr(pa, "paged_attention_plain", record)
    cfg = get_config("tiny")
    model = Model(cfg, init_params(cfg, torch.Generator().manual_seed(5),
                                   device="cpu"))
    batch = ChainTask().serve_batch(np.random.default_rng(2), 3)
    res = {}
    for side in ("ring", "paged"):
        kind[0] = side
        ecfg = EngineConfig(max_reasoning_tokens=8, capacity=200, chunk_len=4,
                            sampler=SamplerConfig(greedy=True),
                            cache=CacheConfig(kind=side, page_size=16,
                                              attn_impl="auto"))
        mon = ReasoningMonitor(stopper=EATStopper(delta=1e9),
                               probe=make_probe(1, (6,)), schedule="every_n",
                               every_n=4, min_evals=1)
        res[side] = ReasoningEngine(model, ecfg, mon).serve(
            batch["prompts"], batch["prompt_len"], batch_size=2, answer_len=2)
    plans = set()
    for side, seen in calls.items():
        assert seen, f"no paged-attention call in the {side} serve"
        for ps, logical, counts, num_blocks in seen:
            assert ps == 16
            plans.add(pa.split_plan(ps, num_blocks))
            for b in range(logical.shape[0]):
                lb = logical[b, :int(counts[b])].tolist()
                assert lb == sorted(set(lb)) and all(0 <= x < num_blocks for x in lb)
                if side == "ring":
                    assert lb == list(range(num_blocks))
    assert plans == {pa.split_plan(16, 13)}
    for r, o in zip(res["ring"], res["paged"]):
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])


def test_cuda_wrapper_needs_the_logical_blocks():
    """Without ``logical`` (or the capacity) the kernel's wrapper
    refuses the call before it looks at devices or loads the library: these
    CPU tensors would otherwise fail its device check."""
    c = _case(m=1, Hq=2, Hkv=2)
    t = torch.from_numpy
    args = (_t(c["q"], torch.float32), _t(c["kp"], torch.float32),
            _t(c["vp"], torch.float32), t(c["pages"]), t(c["counts"]),
            t(c["bpos"]), t(c["q_pos"]))
    with pytest.raises(ValueError, match="logical"):
        pa.paged_attention_cuda(*args, scale=0.25)
    with pytest.raises(ValueError, match="logical"):
        pa.paged_attention_cuda(*args, scale=0.25, logical=t(c["logical"]))


def test_launcher_passes_the_sampler_flags(monkeypatch):
    """The launcher's --top-k / --typical-p / --min-p reach SamplerConfig,
    with the reference launcher's defaults (0, 1.0, 0.0)."""
    made = []

    def capture(**kw):
        made.append(SamplerConfig(**kw))
        return made[-1]

    monkeypatch.setattr(launcher, "SamplerConfig", capture)
    base = ["--device", "cpu", "--arch", "tiny", "--batch", "2", "--budget", "4",
            "--chunk", "4"]
    launcher.main(base + ["--top-k", "5", "--typical-p", "0.9", "--min-p", "0.05"])
    launcher.main(base)
    assert [(s.top_k, s.typical_p, s.min_p) for s in made] == [(5, 0.9, 0.05),
                                                              (0, 1.0, 0.0)]
