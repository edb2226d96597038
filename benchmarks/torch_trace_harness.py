"""The paper's App. H offline protocol on the PyTorch port (imports no jax).

Generate ONE long reasoning chain per question and record, at every
evaluation point: token count, EAT, K forced-rollout answers and the
5-token greedy confidence (Eq. 16), through the port's
``ReasoningEngine.reason_with_trace``.  The stopping rules are then
*replayed* over that trace (Alg. 1 EAT, Alg. 2 token budget, Alg. 3 #UA@K)
without querying the model again.

    trace = build_trace(engine, batch, rollout_k=16, rollout_len=4,
                        max_tokens=128, rng=torch.Generator().manual_seed(0))
    exit_line = replay_ema_stop(trace, trace["eat"], alpha=0.2, delta=1e-3)

``build_trace`` takes the engine and the batch (``ChainTask.serve_batch``:
``prompts``, ``prompt_len``, ``answers``, ``k``) as arguments and trains
nothing: the accuracy of a trace means something only with trained
weights.  The replays are copies of ``benchmarks/trace_harness.py``'s.
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.data.synthetic import ChainTask  # noqa: E402


def build_trace(engine, batch: dict, *, rollout_k: int, rollout_len: int,
                max_tokens: int, rng, confidence_len: int = 5) -> dict:
    """The trace of ``batch`` under ``engine`` (a port ``ReasoningEngine``):
    ``answers_true`` and ``k`` (B,), then per evaluation line ``n_tokens``,
    ``due``, ``eat`` and ``confidence`` (L, B) and ``answers`` (L, K, B).
    ``rng``: the chain's ``torch.Generator`` (the rollouts draw from a copy
    of it)."""
    st = engine.start(batch["prompts"], batch["prompt_len"], rng)
    _, trace = engine.reason_with_trace(
        st, max_tokens=max_tokens, rollout_k=rollout_k, rollout_len=rollout_len,
        answer_extract=ChainTask.extract_answer, confidence_len=confidence_len)
    return {
        "answers_true": batch["answers"],
        "k": batch["k"],
        "n_tokens": np.stack([r["n_tokens"] for r in trace]),       # (L, B)
        "due": np.stack([r["due"] for r in trace]),                 # (L, B)
        "eat": np.stack([r["eat"] for r in trace]),                 # (L, B)
        "answers": np.stack([r["answers"] for r in trace]),         # (L, K, B)
        "confidence": np.stack([r["confidence"] for r in trace]),   # (L, B)
    }


# ----------------------------------------------------------------- replay


def pass1_at_line(tr: dict, line: np.ndarray) -> np.ndarray:
    """Pass@1(Avg@K) per question at (per-question) line indices."""
    L, K, B = tr["answers"].shape
    li = np.clip(line, 0, L - 1)
    ans = tr["answers"][li, :, np.arange(B)]        # (B, K)
    return (ans == tr["answers_true"][:, None]).mean(axis=1)


def tokens_at_line(tr: dict, line: np.ndarray) -> np.ndarray:
    L, B = tr["n_tokens"].shape
    li = np.clip(line, 0, L - 1)
    return tr["n_tokens"][li, np.arange(B)]


def replay_ema_stop(tr: dict, signal: np.ndarray, alpha: float, delta: float,
                    min_evals: int = 2) -> np.ndarray:
    """Replay Alg. 1 (EMA variance threshold, de-biased) over a per-line
    signal; returns per-question exit line index (L-1 if never)."""
    L, B = signal.shape
    m = np.zeros(B)
    v = np.zeros(B)
    n = np.zeros(B, int)
    exit_line = np.full(B, L - 1)
    done = np.zeros(B, bool)
    for i in range(L):
        use = tr["due"][i] & ~done
        x = signal[i]
        m_new = (1 - alpha) * m + alpha * x
        v_new = (1 - alpha) * v + alpha * (x - m_new) ** 2
        m = np.where(use, m_new, m)
        v = np.where(use, v_new, v)
        n = n + use.astype(int)
        debias = 1 - (1 - alpha) ** np.maximum(n, 1)
        fire = use & (n >= min_evals) & (v / debias < delta)
        exit_line[fire & ~done] = i
        done |= fire
    return exit_line


def replay_token_budget(tr: dict, budget: int) -> np.ndarray:
    L, B = tr["n_tokens"].shape
    exit_line = np.full(B, L - 1)
    for b in range(B):
        hits = np.nonzero(tr["n_tokens"][:, b] >= budget)[0]
        if len(hits):
            exit_line[b] = hits[0]
    return exit_line


def replay_ua_stop(tr: dict, k: int, max_unique: int, rng=None) -> np.ndarray:
    """#UA@K (Alg. 3): exit when #unique among k of the K recorded rollouts
    <= max_unique."""
    L, K, B = tr["answers"].shape
    rng = rng or np.random.default_rng(0)
    sel = rng.choice(K, size=min(k, K), replace=False)
    exit_line = np.full(B, L - 1)
    done = np.zeros(B, bool)
    for i in range(L):
        ans = tr["answers"][i][sel]               # (k, B)
        uniq = np.array([len(set(ans[:, b])) for b in range(B)])
        fire = tr["due"][i] & (uniq <= max_unique) & ~done
        exit_line[fire] = i
        done |= fire
    return exit_line


def curve_auc(tokens: np.ndarray, acc: np.ndarray,
              t_range: tuple | None = None) -> float:
    """Area under the accuracy-vs-tokens curve, normalized over a token
    range (larger = more efficient).  Pass a common ``t_range`` when
    comparing methods (curves are step-interpolated and clamped to their
    endpoint values outside their observed range)."""
    order = np.argsort(tokens)
    t, a = np.asarray(tokens, float)[order], np.asarray(acc, float)[order]
    lo, hi = t_range if t_range is not None else (t[0], t[-1])
    if hi == lo:
        return float(a.mean())
    grid = np.linspace(lo, hi, 256)
    vals = np.interp(grid, t, a, left=a[0], right=a[-1])
    return float(np.trapezoid(vals, grid) / (hi - lo))
