"""Where a forced answer's keys sit, against the paged kernel's split, on
the CPU.

The overlapped serve loop dispatches chunk N+1 before it reads boundary N.
In proxy mode the generator decodes that chunk blind (the proxy's verdict
on chunk N lands one boundary late, ``Executor.retract_lagged``), so the
shared ring pointer has moved on by the chunk's live steps when boundary
N's harvest rolls out its forced answers: a harvested row's answer keys
(``</think>`` and the answer tokens) land a chunk later than in the sync
loop, with masked slots (the retracted tokens) between them and the row's
reasoning.  The JAX reference's loop moves its pointer the same way.

A masked slot is an exact identity step of the sequential block scan (the
plain version, the reference's ``block_decode_attention``), so there the
answer's attention is bitwise the same wherever its keys sit.  The CUDA
kernel splits each row's keys at fixed 64-key logical boundaries
(``ops.split_plan``) and adds the splits' partial sums in split order:
with the prompt's splits before them, a reasoning block and an answer
block in one split are summed as prompt + (reasoning + answer), in two
splits as (prompt + reasoning) + answer, which changes the output's last
bits.  Under bf16 logits that can turn a near tie: on an
H100, ``eat-paper-8b`` cut to 18 layers with the ``qwen3-1.7b`` proxy, one
request's fourth answer token differed between the loops, its top two
logits one bf16 ulp apart (PERF.md; `test_torch_split_offsets_cuda.py`).

* With the kernel's split order emulated in torch
  (``test_torch_paged_split._emulate``), the same keys, positions and
  query in the sync layout (a 64-token prompt in split 0, the reasoning
  and the answer in split 1) and in the overlapped one (the reasoning a
  block later, the answer in split 2) give outputs that differ in their
  last bits and stay within float32 noise of each other, while the plain
  scan gives bitwise equal outputs; moving the answer inside split 1
  changes no bit.
* On ``tiny`` with the ``tiny-proxy`` monitor (paged, greedy), the
  overlapped loop's harvest rollouts run at ring pointers at least a
  chunk past the sync loop's, and the tokens, exits and answers are
  equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops as pa

from _torch_threads import _one_thread  # noqa: F401
from test_torch_paged_split import _emulate
from test_torch_pipeline import BATCH, _engine, _pair

PS, NB, D = 16, 12, 32
PROMPT = 64


def _layout(reason_at: int, answer_at: int, n_reason=16, n_answer=5, seed=0):
    """A ring cache of one 64-token prompt (slots 0..63: split 0), 16
    reasoning tokens at slots ``reason_at``.. and 5 answer keys at
    ``answer_at``..,
    every other slot masked; the K/V of a position are the same wherever
    it sits.  The query is the last answer token's.  Rows: 3, 8 q heads on
    2 kv heads."""
    B, Hq, Hkv = 3, 8, 2
    rng = np.random.default_rng(seed)
    n_pos = PROMPT + n_reason + n_answer
    kv = rng.standard_normal((2, B, n_pos, Hkv, D)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, D)).astype(np.float32))
    slots = np.concatenate([np.arange(PROMPT), reason_at + np.arange(n_reason),
                            answer_at + np.arange(n_answer)])
    k = torch.zeros((B, NB * PS, Hkv, D))
    v = torch.zeros_like(k)
    kv_pos = torch.full((B, NB * PS), -1, dtype=torch.int32)
    k[:, slots] = torch.from_numpy(kv[0])
    v[:, slots] = torch.from_numpy(kv[1])
    kv_pos[:, slots] = torch.arange(n_pos, dtype=torch.int32)
    q_pos = torch.full((B, 1), n_pos - 1, dtype=torch.int32)
    return q, k, v, q_pos, kv_pos


def _ring_emulated(q, k, v, q_pos, kv_pos):
    """The kernel's split order over the ring's identity page list."""
    B = q.shape[0]
    K, n_split = pa.split_plan(PS, NB)
    ranks = torch.arange(NB, dtype=torch.int32)
    pages = torch.arange(B, dtype=torch.int32)[:, None] * NB + ranks
    pool = lambda t: t.reshape(B * NB, PS, *t.shape[2:])  # noqa: E731
    return _emulate(q, pool(k), pool(v), pages, torch.full((B,), NB, dtype=torch.int32),
                    kv_pos.reshape(B, NB, PS), q_pos, ranks.expand(B, NB),
                    K=K, n_split=n_split, scale=D ** -0.5)


def test_answer_keys_a_split_later_move_the_kernels_last_bits_only():
    K = pa.split_plan(PS, NB)[0]
    assert K * PS == 64
    # sync: reasoning in block 4, the answer in block 5 (both split 1);
    # overlapped: the reasoning a block later, the answer in block 8 (split 2)
    sync, over = _layout(64, 80), _layout(80, 128)
    plain = [pa.ring_decode_attention(*c, page_size=PS, scale=D ** -0.5, impl="plain")
             for c in (sync, over)]
    assert torch.equal(plain[0], plain[1])
    kern = [_ring_emulated(*c) for c in (sync, over)]
    assert not torch.equal(kern[0], kern[1])
    torch.testing.assert_close(kern[0], kern[1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(kern[0], plain[0], atol=1e-6, rtol=1e-6)
    # the same move inside one split changes no bit of the kernel's either
    inside = _ring_emulated(*_layout(64, 96))
    assert torch.equal(inside, kern[0])


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair("tiny", 11)[2], _pair("tiny-proxy", 5)[2]


def test_overlapped_proxy_rollouts_run_a_chunk_later(tiny_pair):
    """Every harvest rolls out in both loops, the overlapped loop's at a
    ring pointer at least a chunk past the sync loop's, and the results
    (tokens, exits, slots, answers) are the sync loop's."""
    from repro_torch.data.synthetic import ChainTask

    gen, proxy = tiny_pair
    b = ChainTask().serve_batch(np.random.default_rng(7), 6)
    eng = _engine(gen, kind="paged", proxy=proxy)
    curs = []
    rollout = eng.executor.rollout

    def recorded(cache, next_pos, rng, **kw):
        curs.append(int(cache["cur"]))
        return rollout(cache, next_pos, rng, **kw)

    eng.executor.rollout = recorded
    kw = dict(batch_size=BATCH, max_tokens=24, answer_len=4)
    sync = eng.serve(b["prompts"], b["prompt_len"], None, **kw)
    sync_curs = list(curs)
    curs.clear()
    over = eng.serve(b["prompts"], b["prompt_len"], None, overlap=True, **kw)
    chunk = eng.ecfg.chunk_len
    assert sync_curs and curs
    assert len(curs) == len(sync_curs)
    assert all(o - s >= chunk for s, o in zip(sync_curs, curs))
    for r, o in zip(sync, over):
        assert (r["n_reasoning"], r["exit_reason"], r["slot"]) == \
               (o["n_reasoning"], o["exit_reason"], o["slot"])
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        np.testing.assert_array_equal(r["answer_tokens"], o["answer_tokens"])
