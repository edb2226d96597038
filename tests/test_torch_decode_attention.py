"""The port's flash-decode op (``repro_torch.kernels.decode_attention``)
against the JAX reference on the CPU.

The plain version follows the TPU kernel's arithmetic, so it is held to
``decode_attention_pallas`` (interpret mode, as the reference's own tests
run it) and to ``attention_ref`` over the reference's sweep
(tests/test_kernels_attention.py: m 1/2/5 x window 0/16 x f32/bf16), at the
reference's tolerances: 1e-5 in float32 (two float32 online softmaxes that
differ by block size and summation order), 3e-2 in bfloat16 (one output
rounding).  Inputs are made with numpy from a seed and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ops import decode_attention as jdecode
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.decode_attention import ops as da


def _inputs(B, m, C, Hq, Hkv, Dk, Dv, *, offset, invalid, seed=0):
    """float32 numpy inputs; the kv positions 0..C-1 with the last
    ``invalid`` slots empty, the m queries at offset..offset+m-1."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, m, Hq, Dk)).astype(np.float32)
    k = rng.normal(size=(B, C, Hkv, Dk)).astype(np.float32)
    v = rng.normal(size=(B, C, Hkv, Dv)).astype(np.float32)
    qp = np.broadcast_to(np.arange(m) + offset, (B, m)).astype(np.int32)
    kp = np.broadcast_to(np.arange(C), (B, C)).astype(np.int32).copy()
    if invalid:
        kp[:, -invalid:] = -1
    return q, k, v, qp, kp


def _torch(arrays, dtype):
    q, k, v, qp, kp = arrays
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return t(q).to(dtype), t(k).to(dtype), t(v).to(dtype), t(qp), t(kp)


def _jax(arrays, dtype):
    q, k, v, qp, kp = arrays
    return (jnp.asarray(q).astype(dtype), jnp.asarray(k).astype(dtype),
            jnp.asarray(v).astype(dtype), jnp.asarray(qp), jnp.asarray(kp))


@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_ref(m, window, dtype):
    """The reference's decode sweep: B 2, Hq 8, Hkv 2, Dk 64, Dv 32, C 70
    (20 empty slots), queries at 40.. ."""
    arrays = _inputs(2, m, 70, 8, 2, 64, 32, offset=40, invalid=20)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = da.decode_attention(*_torch(arrays, tdt), window=window)
    assert out.dtype == tdt and out.shape == (2, m, 8, 32)
    ja = _jax(arrays, jdt)
    kern = decode_attention_pallas(*ja, window=window, block_kv=32,
                                   interpret=True)
    ref = attention_ref(*ja, window=window)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for r in (kern, ref):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(r, np.float32),
                                   atol=tol, rtol=tol)


def test_plain_matches_jax_op_at_decode_widths():
    """The JAX op's own dispatch (the XLA attention on the CPU) at GQA
    group 4, head dim 128 and a cache spanning several plain blocks."""
    arrays = _inputs(2, 2, 1100, 8, 2, 128, 128, offset=1000, invalid=37, seed=3)
    out = da.decode_attention(*_torch(arrays, torch.float32))
    ref = jdecode(*_jax(arrays, jnp.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_slot_order_is_irrelevant():
    """A ring cache: the same keys under a permutation of the slots give
    the same attention (within float32 summation order)."""
    q, k, v, qp, kp = _inputs(2, 2, 600, 4, 2, 32, 32, offset=600, invalid=50,
                              seed=1)
    perm = np.random.default_rng(9).permutation(600)
    ref = da.decode_attention(*_torch((q, k, v, qp, kp), torch.float32), window=300)
    out = da.decode_attention(
        *_torch((q, k[:, perm], v[:, perm], qp, kp[:, perm]), torch.float32),
        window=300)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_row_with_no_valid_key_is_zero():
    """Row 0's cache is empty, row 1's keys all lie past its query: both
    give exactly 0 (never NaN), while row 2 attends normally."""
    q, k, v, qp, kp = _inputs(3, 1, 40, 4, 2, 16, 16, offset=39, invalid=0)
    kp[0] = -1
    kp[1] = np.arange(100, 140)
    out = da.decode_attention(*_torch((q, k, v, qp, kp), torch.float32))
    assert torch.equal(out[:2], torch.zeros_like(out[:2]))
    assert bool(torch.isfinite(out).all()) and float(out[2].abs().max()) > 0


def test_cuda_impl_on_cpu_tensors_raises():
    t = _torch(_inputs(1, 1, 8, 2, 1, 16, 16, offset=7, invalid=0), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(*t, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(*t, scale=0.25)


@pytest.mark.parametrize("C,bh,slots,n_split,split_len", [
    (4096, 32, 264, 8, 512),     # eat-paper-8b at B 4, 2 blocks/SM x 132 SMs
    (4096, 32, 396, 11, 384),    # the same at 3 blocks per SM
    (70, 4, 264, 2, 64),         # a ragged last tile
    (64, 32, 264, 1, 64),        # one tile: one split
    (4096, 512, 264, 1, 4096),   # enough (b, h) blocks already
    (65536, 1, 264, 64, 1024),   # at most MAX_SPLIT splits
])
def test_split_plan_covers_the_sms(C, bh, slots, n_split, split_len):
    """Whole tiles per split, the grid within one wave of ``slots``
    resident blocks and at least half of it where the cache has the
    tiles."""
    assert da.split_plan(C, bh, slots) == (n_split, split_len)
    n, ln = n_split, split_len
    assert (n - 1) * ln < C <= n * ln and ln % 64 == 0 and n <= da.MAX_SPLIT
    assert n * bh <= max(slots, bh)
    assert 2 * n * bh > min(slots, bh * min(-(-C // 64), da.MAX_SPLIT))
