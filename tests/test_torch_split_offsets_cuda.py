"""The overlapped proxy serve's forced answers on the card, where the
paged kernel's split meets a near tie (the CPU side, with the kernel's
split order emulated, is ``tests/test_torch_split_offsets.py``).

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_split_offsets_cuda.py

``eat-paper-8b`` cut to 18 of its 36 layers (seeded random weights, bf16),
monitored by ``qwen3-1.7b`` (seed 2), serves ``chip_smoke.py``'s phase-4
traffic (8 prompts of 128-512 tokens, 4 slots, budget 64, chunk 16, page
16, greedy, a probe every 8 tokens, exit at the 2nd evaluation, answers of
4) through the paged cache, sync and overlapped.  Every harvest rollout
is first run eagerly as well, recording the ring pointer, each row's
top-two bf16 logits at every answer step, and the answer tokens of the
plain paged read on the same cache.

* Every request's tokens, exits and slots are the sync loop's.
* The overlapped loop rolls its answers out at ring pointers at least a
  chunk past the sync loop's (the generator decoded the chunk in flight
  blind; ``Executor.retract_lagged``).
* With the plain paged read (a sequential block scan, which masked slots
  leave bitwise unchanged) the answers are equal in both loops.
* With the kernel, an answer token may differ between the loops only
  where the two top logits of that step lie within one bf16 ulp of each
  other, in both loops: a near tie that the kernel's split-order sums
  turn.  The readings are printed (``-s``).
"""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

LAYERS = 18


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _workload(vocab=151_936, n_req=8, seed=0):
    """``chip_smoke.py``'s ``serve_workload``: 8 seeded prompts of 128-512
    tokens, left-padded to the longest."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 513, n_req)
    lens[0] = 512
    prompts = np.zeros((n_req, 512), np.int64)
    for i, n in enumerate(lens):
        prompts[i, 512 - n:] = rng.integers(16, vocab, n)
    return prompts, lens.astype(np.int32)


def _rollout(ex, model, cache, next_pos, n):
    """``Executor._rollout_body``, greedy and eager, on ``model``'s paged
    read: (tokens (B, n), per step the top two logits and their ids)."""
    from repro_torch.models.transformer import preserved_slots, write_slots
    from repro_torch.serving.sampler import sample

    ecfg, vocab = ex.ecfg, model.cfg.vocab
    B = next_pos.shape[0]
    pos, cur = cache["pos"].clone(), cache["cur"].clone()
    local = dict(cache, pos=pos, cur=cur, layers=list(cache["layers"]))
    slots = write_slots(cur, n + 1, pos.shape[1], next_pos.device)
    scfg = dataclasses.replace(ecfg.sampler, greedy=True)
    toks, tops = [], []
    with preserved_slots(cache, slots):
        p1 = next_pos[:, None]
        et = torch.full((B, 1), ecfg.end_think_id, dtype=torch.long, device=p1.device)
        logit = model.decode_step(et, p1, p1, local)[:, -1]
        p = next_pos + 1
        for _ in range(n):
            v, i = logit[:, :vocab].float().topk(2, dim=-1)
            tops.append((v.tolist(), i.tolist()))
            tok = sample(logit, vocab, scfg, None)
            toks.append(tok)
            logit = model.decode_step(tok[:, None], p[:, None], p[:, None], local)[:, -1]
            p = p + 1
    return torch.stack(toks, 1).tolist(), tops


def _ulp(x: float) -> float:
    """One bf16 ulp at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def test_overlapped_proxy_answers_differ_only_at_near_ties(cuda):
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.proxy import ProxyConfig
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.scheduler import SlotScheduler

    cfg = dataclasses.replace(get_config("eat-paper-8b"), n_layers=LAYERS)
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda))
    qcfg = get_config("qwen3-1.7b")
    qmodel = Model(qcfg, init_params(qcfg, torch.Generator(cuda).manual_seed(2),
                                     device=cuda))
    prompts, lens = _workload()
    batch, budget, chunk = 4, 64, 16
    capacity = SlotScheduler.required_capacity(512, len(lens), batch, budget) + chunk
    n_blocks = -(-capacity // 16)
    ecfg = EngineConfig(max_reasoning_tokens=budget, capacity=capacity, chunk_len=chunk,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind="paged", page_size=16, attn_impl="auto",
                                          num_pages=(batch + 1) * n_blocks + 1))
    mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=1e9),
                           probe=make_probe(1, (6,)), schedule="every_n", every_n=8,
                           min_evals=2)
    eng = ReasoningEngine(model, ecfg, mon, proxy=ProxyConfig(model=qmodel))
    ex = eng.executor
    plain = copy.copy(ex.model)
    plain.paged_attn_impl = "plain"
    log = []
    graph_rollout = ex.rollout

    def rollout(cache, next_pos, rng, *, n, greedy=False, eager=False):
        torch.cuda.synchronize()
        toks, tops = _rollout(ex, ex.model, cache, next_pos, n)
        log.append({"cur": int(cache["cur"]), "next_pos": next_pos.tolist(),
                    "kernel": toks, "tops": tops,
                    "plain": _rollout(ex, plain, cache, next_pos, n)[0]})
        out = graph_rollout(cache, next_pos, rng, n=n, greedy=greedy, eager=eager)
        assert out[0].tolist() == toks          # the replay is the eager rollout
        return out

    ex.rollout = rollout
    kw = dict(batch_size=batch, answer_len=4, record_trace=True)
    sync = eng.serve(prompts, lens, None, **kw)
    n_sync = len(log)
    over = eng.serve(prompts, lens, None, overlap=True, **kw)

    def given(lo, hi, slot, answers):
        """The rollouts of ``log[lo:hi]`` whose row ``slot`` holds a
        request's answers (the harvest's, and an earlier one of the same
        row state in the overlapped loop, whose rollouts run for the whole
        batch at every harvest)."""
        recs = [r for r in log[lo:hi] if r["kernel"][slot] == answers]
        assert recs, f"slot {slot}: no rollout gave the answers {answers}"
        return recs

    flips = []
    for i, (a, b) in enumerate(zip(sync, over)):
        assert (a["n_reasoning"], a["exit_reason"], a["slot"]) == \
               (b["n_reasoning"], b["exit_reason"], b["slot"])
        np.testing.assert_array_equal(a["reasoning_tokens"], b["reasoning_tokens"])
        s = a["slot"]
        rs = given(0, n_sync, s, [int(x) for x in a["answer_tokens"]])
        ro = given(n_sync, len(log), s, [int(x) for x in b["answer_tokens"]])
        assert min(r["cur"] for r in ro) - max(r["cur"] for r in rs) >= chunk
        assert {tuple(r["plain"][s]) for r in rs + ro} == {tuple(rs[0]["plain"][s])}
        diff = [k for k, (x, y) in enumerate(zip(a["answer_tokens"], b["answer_tokens"]))
                if x != y]
        if not diff:
            continue
        step = diff[0]
        for rec in rs + ro:
            v1, v2 = rec["tops"][step][0][s]
            assert v1 - v2 <= _ulp(v1), (i, step, rec["cur"], v1, v2)
        flips.append({"request": i, "step": step + 1,
                      "sync": [{"cur": r["cur"], "top2": r["tops"][step][0][s],
                                "ids": r["tops"][step][1][s]} for r in rs],
                      "overlapped": [{"cur": r["cur"], "top2": r["tops"][step][0][s],
                                      "ids": r["tops"][step][1][s]} for r in ro],
                      "plain_answers": rs[0]["plain"][s]})
    print(f"[split offsets] eat-paper-8b at {LAYERS} layers, qwen3-1.7b proxy: "
          f"answer tokens that differ between the loops, each at a near tie: "
          f"{json.dumps(flips)}")
