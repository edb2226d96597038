"""Per-module parity of the PyTorch port against the JAX reference, on the
CPU: the same numpy inputs through the JAX function and its port.

Where the JAX side reaches a Pallas kernel it runs the way the reference's
own tests run it (interpret mode), and also through its XLA path; the port
runs its plain PyTorch versions (on CPU tensors the dispatchers take them).
Tolerances: 1e-5 per float32 op (the bar of test_kernels_entropy.py),
2e-5 for float32 attention (the bar of test_kernels_attention.py), 3e-2 in
bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.kernels.entropy_probe.kernel import entropy_probe_pallas
from repro.kernels.entropy_probe.ops import _xla_entropy
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import _xla_attention
from repro.kernels.paged_attention import ops as jpa
from repro.models import attention as jatt
from repro.models import common as jcom
from repro.serving import sampler as jsamp
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.kernels.entropy_probe import ops as ep
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcom
from repro_torch.serving import sampler as tsamp

BF16_TOL = 3e-2


def t(a, dtype=None):
    x = torch.from_numpy(np.array(a, np.float32) if dtype is not None
                         else np.array(a))
    return x.to(dtype) if dtype is not None else x


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def close(out_t, out_j, tol):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol, rtol=tol)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(3, 5, 128)) * 3, rng.normal(size=(128,))
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    for one_plus in (False, True):
        ref = jcom.rmsnorm(j(x, jnp.dtype(dtype)), j(w, jnp.dtype(dtype)),
                           1e-6, one_plus)
        out = tcom.rmsnorm(t(x, getattr(torch, dtype)), t(w, getattr(torch, dtype)),
                           1e-6, one_plus)
        assert out.dtype == getattr(torch, dtype)
        close(out, ref, tol)


def test_apply_rope_matches_jax():
    """head_dim 128, theta 1e6 (eat-paper-8b), positions past 4k."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 128))
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    ref = jcom.apply_rope(j(x), jnp.asarray(pos), 1e6)
    out = tcom.apply_rope(t(x, torch.float32), torch.from_numpy(pos), 1e6)
    # angles reach ~5e3 rad: one float32 ulp of the angle is ~5e-4, so the
    # bar is that of a float32 trig evaluation at that magnitude
    close(out, ref, 1e-3)
    small = rng.integers(0, 64, size=(2, 7)).astype(np.int32)
    close(tcom.apply_rope(t(x, torch.float32), torch.from_numpy(small), 1e6),
          jcom.apply_rope(j(x), jnp.asarray(small), 1e6), 1e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_gqa_qkv_with_qk_norm_matches_jax(bias):
    kw = dict(n_layers=1, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
              d_ff=64, vocab=64, qk_norm=True, attn_bias=bias,
              rope_theta=1e6, dtype="float32")
    jc, tc = JConfig(**kw), TConfig(**kw)
    p = jatt.gqa_init(jax.random.PRNGKey(0), jc, jnp.float32)
    rng = np.random.default_rng(2)
    if bias:
        p = {k: (j(rng.normal(size=v.shape)) if k.startswith("b") else v)
             for k, v in p.items()}
    p["q_norm"] = j(rng.normal(size=(16,)))
    tp = {k: t(np.asarray(v), torch.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, 64))
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    for a, b in zip(tatt.gqa_qkv(tp, t(x, torch.float32), torch.from_numpy(pos), tc),
                    jatt.gqa_qkv(p, j(x), jnp.asarray(pos), jc)):
        close(a, b, 1e-5)
    o = rng.normal(size=(2, 5, 8, 16))
    close(tatt.gqa_out(tp, t(o, torch.float32)), jatt.gqa_out(p, j(o)), 1e-5)
    assert tatt.attn_scale(tc) == jatt.attn_scale(jc)


def test_mlp_embed_lm_head_match_jax():
    kw = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=48,
              vocab=200, tie_embeddings=True, dtype="float32")
    jc, tc = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(3)
    ffn = jcom.mlp_init(jax.random.PRNGKey(1), jc, 48, jnp.float32)
    emb = jcom.embed_init(jax.random.PRNGKey(2), jc, jnp.float32)
    x = rng.normal(size=(2, 3, 32))
    tt = lambda d: {k: t(np.asarray(v), torch.float32) for k, v in d.items()}  # noqa: E731
    close(tcom.mlp_apply(tt(ffn), t(x, torch.float32), tc),
          jcom.mlp_apply(ffn, j(x), jc), 1e-5)
    toks = rng.integers(0, 200, size=(2, 3))
    close(tcom.embed_apply(tt(emb), torch.from_numpy(toks), tc),
          jcom.embed_apply(emb, jnp.asarray(toks), jc), 1e-6)
    close(tcom.lm_head_apply(tt(emb), t(x, torch.float32), tc),
          jcom.lm_head_apply(emb, j(x), jc), 1e-5)
    assert tc.padded_vocab == jc.padded_vocab == 256


# ------------------------------------------------------- flash attention


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, Dk, Dv, window
    (1, 16, 16, 1, 1, 32, 32, 0),
    (2, 33, 47, 4, 2, 64, 64, 0),
    (2, 33, 47, 4, 2, 64, 64, 8),
    (2, 40, 150, 8, 2, 16, 16, 0),       # g = 4, two kv chunks
    (1, 12, 30, 4, 1, 96, 64, 0),        # Dv != Dk
]


def _attn_inputs(case, seed=0):
    B, Sq, Skv, Hq, Hkv, Dk, Dv, window = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, Dk))
    k = rng.normal(size=(B, Skv, Hkv, Dk))
    v = rng.normal(size=(B, Skv, Hkv, Dv))
    qp = np.broadcast_to(np.arange(Sq) + 4, (B, Sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Skv), (B, Skv)).astype(np.int32).copy()
    kp[:, -3:] = -1
    return q, k, v, qp, kp, window, 1.0 / np.sqrt(Dk)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(case, dtype):
    """The plain flash attention vs the reference's XLA path and its Pallas
    kernel in interpret mode."""
    q, k, v, qp, kp, window, scale = _attn_inputs(case)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    out = fa.attention(t(q, td), t(k, td), t(v, td), torch.from_numpy(qp),
                       torch.from_numpy(kp), window=window, scale=scale)
    tol = 2e-5 if dtype == "float32" else BF16_TOL
    args = (j(q, jd), j(k, jd), j(v, jd), jnp.asarray(qp), jnp.asarray(kp))
    close(out, _xla_attention(*args, causal=True, window=window, scale=scale), tol)
    close(out, flash_attention_pallas(*args, window=window, scale=scale,
                                      block_q=16, block_kv=16, interpret=True), tol)


def test_flash_plain_noncausal_and_empty_rows():
    q, k, v, qp, kp, _, scale = _attn_inputs((2, 9, 21, 4, 4, 32, 32, 0))
    kp[1] = -1                                    # row 1 has no valid key
    out = fa.attention_plain(t(q, torch.float32), t(k, torch.float32),
                             t(v, torch.float32), torch.from_numpy(qp),
                             torch.from_numpy(kp), causal=False, scale=scale)
    ref = _xla_attention(j(q), j(k), j(v), jnp.asarray(qp), jnp.asarray(kp),
                         causal=False, window=0, scale=scale)
    close(out, ref, 2e-5)
    assert (out[1] == 0).all()


def test_flash_plain_ignores_trailing_masked_slots_bitwise():
    """A ring cache larger than the prompt and a prompt-sized cache give
    bitwise equal prefill attention (fully masked chunks are identity
    steps) — the prefill half of the port's paged == ring contract."""
    q, k, v, qp, kp, _, scale = _attn_inputs((2, 20, 20, 4, 2, 16, 16, 0))
    kp[:] = np.arange(20)
    big_k = np.concatenate([k, np.random.default_rng(5).normal(size=(2, 300, 2, 16))], 1)
    big_v = np.concatenate([v, np.random.default_rng(6).normal(size=(2, 300, 2, 16))], 1)
    big_p = np.concatenate([kp, np.full((2, 300), -1, np.int32)], 1)
    a = fa.attention_plain(t(q, torch.float32), t(k, torch.float32),
                           t(v, torch.float32), torch.from_numpy(qp),
                           torch.from_numpy(kp), scale=scale)
    b = fa.attention_plain(t(q, torch.float32), t(big_k, torch.float32),
                           t(big_v, torch.float32), torch.from_numpy(qp),
                           torch.from_numpy(big_p), scale=scale)
    assert torch.equal(a, b)


# ------------------------------------------------------- paged attention


HOLES = [[0, 1, 2, 12], [0, 1, 2, 3, 4, 5], [0, 12, 13],
         [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]]


def _paged_case(*, m, Hq, Hkv, D=16, ps=16, NB=16, seed=0):
    """numpy copy of tests/test_paged_attention.py's make_paged_case: a
    dense ring and a garbage-filled pool with the same written values."""
    rng = np.random.default_rng(seed)
    B, C = len(HOLES), NB * ps
    kd = np.zeros((B, C, Hkv, D), np.float32)
    vd = np.zeros((B, C, Hkv, D), np.float32)
    kv_pos = np.full((B, C), -1, np.int32)
    P = sum(len(bl) for bl in HOLES) + 4
    kp = rng.normal(size=(P, ps, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, ps, Hkv, D)).astype(np.float32)
    NBK = max(len(bl) for bl in HOLES) + 2
    pages = np.zeros((B, NBK), np.int32)
    logical = np.zeros((B, NBK), np.int32)
    counts = np.array([len(bl) for bl in HOLES], np.int32)
    nxt = 1
    for b, blocks in enumerate(HOLES):
        for r, blk in enumerate(blocks):
            pages[b, r], logical[b, r] = nxt, blk
            fill = ps if blk != blocks[-1] else ps // 2 + 1
            vk = rng.normal(size=(fill, Hkv, D)).astype(np.float32)
            vv = rng.normal(size=(fill, Hkv, D)).astype(np.float32)
            kp[nxt, :fill], vp[nxt, :fill] = vk, vv
            kd[b, blk * ps:blk * ps + fill] = vk
            vd[b, blk * ps:blk * ps + fill] = vv
            kv_pos[b, blk * ps:blk * ps + fill] = np.arange(blk * ps, blk * ps + fill)
            nxt += 1
    q = rng.normal(size=(B, m, Hq, D)).astype(np.float32)
    q_pos = np.stack([np.arange(C - m, C)] * B).astype(np.int32)
    return dict(q=q, q_pos=q_pos, kd=kd, vd=vd, kv_pos=kv_pos, kp=kp, vp=vp,
                pages=pages, logical=logical, counts=counts, ps=ps)


# m * g in {1, 4, 8} over g in {1, 2, 4}
MG = [(1, 2, 2), (2, 4, 2), (4, 2, 2), (1, 8, 2), (2, 8, 2), (8, 4, 4)]


@pytest.mark.parametrize("m,Hq,Hkv", MG)
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax(m, Hq, Hkv, window, dtype):
    """The plain paged attention vs the reference's XLA block scan and its
    Pallas kernel in interpret mode."""
    c = _paged_case(m=m, Hq=Hq, Hkv=Hkv)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jb = jpa.block_positions(jnp.asarray(c["kv_pos"]), jnp.asarray(c["pages"]),
                             jnp.asarray(c["logical"]), c["ps"])
    tb = pa.block_positions(torch.from_numpy(c["kv_pos"]),
                            torch.from_numpy(c["pages"]),
                            torch.from_numpy(c["logical"]), c["ps"])
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    out = pa.paged_decode_attention(
        t(c["q"], td), t(c["kp"], td), t(c["vp"], td),
        torch.from_numpy(c["pages"]), torch.from_numpy(c["counts"]), tb,
        torch.from_numpy(c["q_pos"]), window=window, scale=0.25)
    tol = 2e-5 if dtype == "float32" else BF16_TOL
    for impl in ("xla", "pallas"):
        ref = jpa.paged_decode_attention(
            j(c["q"], jd), j(c["kp"], jd), j(c["vp"], jd),
            jnp.asarray(c["pages"]), jnp.asarray(c["counts"]), jb,
            jnp.asarray(c["q_pos"]), window=window, scale=0.25, impl=impl,
            interpret=True)
        close(out, ref, tol)


@pytest.mark.parametrize("m,Hq,Hkv", [(2, 4, 2), (1, 8, 1), (2, 6, 3)])
def test_port_paged_equals_ring_bitwise(m, Hq, Hkv):
    """Inside the port: the paged read (mapped pages only, garbage-filled
    pool) equals the ring read (every logical block) bit for bit."""
    c = _paged_case(m=m, Hq=Hq, Hkv=Hkv)
    q, qp = t(c["q"], torch.float32), torch.from_numpy(c["q_pos"])
    bpos = pa.block_positions(torch.from_numpy(c["kv_pos"]),
                              torch.from_numpy(c["pages"]),
                              torch.from_numpy(c["logical"]), c["ps"])
    paged = pa.paged_decode_attention(
        q, t(c["kp"], torch.float32), t(c["vp"], torch.float32),
        torch.from_numpy(c["pages"]), torch.from_numpy(c["counts"]), bpos, qp,
        scale=0.25)
    ring = pa.ring_decode_attention(
        q, t(c["kd"], torch.float32), t(c["vd"], torch.float32), qp,
        torch.from_numpy(c["kv_pos"]), page_size=c["ps"], scale=0.25)
    assert torch.equal(paged, ring)
    # a capacity that is not a page multiple pads with identity steps
    odd = pa.ring_decode_attention(
        q, t(c["kd"][:, :-8], torch.float32), t(c["vd"][:, :-8], torch.float32),
        qp, torch.from_numpy(c["kv_pos"][:, :-8]), page_size=c["ps"], scale=0.25)
    assert torch.equal(odd, ring)


# --------------------------------------------------------- entropy probe


ENT_CASES = [(1, 16, 64, 64), (3, 32, 257, 200), (8, 64, 1024, 1000),
             (5, 128, 2048, 2047), (2, 96, 20000, 19000)]


@pytest.mark.parametrize("case", ENT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entropy_plain_matches_jax(case, dtype):
    """Padded vocab included (vocab < Vp); the JAX side through its XLA
    scan and its Pallas kernel in interpret mode."""
    B, d, Vp, vocab = case
    rng = np.random.default_rng(4)
    h, w = rng.normal(size=(B, d)), rng.normal(size=(d, Vp)) * 0.3
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    out = ep.next_token_entropy(t(h, td), t(w, td), vocab)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    close(out, _xla_entropy(j(h, jd), j(w, jd), vocab), tol)
    if Vp <= 2048:
        close(out, entropy_probe_pallas(j(h, jd), j(w, jd), vocab, block_b=4,
                                        block_v=256, interpret=True), tol)


def test_entropy_tied_view_and_uniform():
    """A tied config's unembedding is the transposed embedding VIEW; zero
    logits give log(vocab)."""
    rng = np.random.default_rng(5)
    emb = t(rng.normal(size=(256, 32)), torch.float32)
    h = t(rng.normal(size=(3, 32)), torch.float32)
    close(ep.next_token_entropy(h, emb.t(), 200),
          _xla_entropy(j(h.numpy()), j(emb.numpy().T), 200), 1e-5)
    out = ep.next_token_entropy(torch.zeros(2, 8), torch.zeros(8, 128), 100)
    np.testing.assert_allclose(out.numpy(), np.log(100), atol=1e-5)


# ------------------------------------------------------------- dispatch


def test_cuda_impl_on_cpu_tensor_raises():
    z = torch.zeros((1, 4, 2, 16))
    pos = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.attention(z, z, z, pos, pos, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.ring_decode_attention(z, z, z, pos, pos, page_size=4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ep.next_token_entropy(torch.zeros(2, 8), torch.zeros(8, 64), 64,
                              impl="cuda")
    # the kernel wrappers themselves refuse CPU tensors too
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(z, z, z, pos, pos, scale=1.0)
    with pytest.raises(ValueError, match="unknown impl"):
        fa.attention(z, z, z, pos, pos, impl="pallas")


# --------------------------------------------------------------- sampler


@pytest.mark.parametrize("kw", [dict(top_k=5), dict(top_p=0.7),
                                dict(typical_p=0.6), dict(min_p=0.2),
                                dict(top_k=10, top_p=0.9, min_p=0.05)])
def test_filter_logits_masks_match_jax(kw):
    rng = np.random.default_rng(6)
    lf = rng.normal(size=(4, 96)).astype(np.float32) * 2
    cfg = dict(temperature=1.0, top_p=1.0)
    cfg.update(kw)
    ref = jsamp.filter_logits(jnp.asarray(lf), jsamp.SamplerConfig(**cfg))
    out = tsamp.filter_logits(torch.from_numpy(lf), tsamp.SamplerConfig(**cfg))
    np.testing.assert_array_equal(np.isfinite(out.numpy()), np.isfinite(np.asarray(ref)))


def test_greedy_sample_and_logprob_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(5, 256)).astype(np.float32)
    logits[0, 250] = 50.0                          # argmax in the padding
    cfg_j, cfg_t = jsamp.SamplerConfig(greedy=True), tsamp.SamplerConfig(greedy=True)
    tok_j = np.asarray(jsamp.sample(jax.random.PRNGKey(0), jnp.asarray(logits), 200, cfg_j))
    tok_t = tsamp.sample(torch.from_numpy(logits), 200, cfg_t).numpy()
    np.testing.assert_array_equal(tok_t, tok_j)
    assert tok_t[0] < 200
    lp_j = jsamp.logprob_of(jnp.asarray(logits), jnp.asarray(tok_j), 200)
    close(tsamp.logprob_of(torch.from_numpy(logits), torch.from_numpy(tok_t), 200),
          lp_j, 1e-5)
    # a categorical draw stays inside the filtered, unpadded set
    gen = torch.Generator().manual_seed(0)
    draws = tsamp.sample(torch.from_numpy(logits), 200,
                         tsamp.SamplerConfig(temperature=0.6, top_k=3), gen)
    top3 = np.argsort(-np.where(np.arange(256) < 200, logits, -np.inf), -1)[:, :3]
    assert all(d in row for d, row in zip(draws.numpy(), top3))


# --------------------------------------------------------------- build


def test_kernel_library_name_tracks_its_sources(tmp_path, monkeypatch):
    """An edited kernel or shared header gives a new library name, so a
    stale build is never loaded; every kernel of the path has a source."""
    from repro_torch.kernels import _build

    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text("a")
    (tmp_path / "common.cuh").write_text("h")
    names = [_build.library_path("k")]
    (tmp_path / "common.cuh").write_text("h2")
    names.append(_build.library_path("k"))
    (tmp_path / "k.cu").write_text("b")
    names.append(_build.library_path("k"))
    assert len(set(names)) == 3
    assert all(p.parent == tmp_path / "_build" for p in names)
    assert _build.library_path("k") == names[-1]
