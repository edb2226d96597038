"""Synthetic "overthinking" chain-of-thought task (copy of
``repro/data/synthetic.py``; numpy only).

A question hides a digit chain s_0 = 0, s_i = (e_i + 2 s_{i-1}) mod 10 with
the e_i given in the prompt; the answer is s_k.

  prompt:    Q <k> e_1 .. e_k <think>
  reasoning: STEP <1> <s_1> \\n\\n ... STEP <k> <s_k> \\n\\n  (+ CHECK lines)
  answer:    </think> ANS <s_k> <eos>

Probe: [</think>, ANS]; EAT measures the answer posterior's entropy.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


class Tokens:
    PAD = 0
    END_THINK = 1          # </think>
    NEWLINE = 2            # "\n\n" paragraph separator
    EOS = 3
    BEGIN_THINK = 4        # <think>
    Q = 5
    ANS = 6                # "The final answer:" prefix
    STEP = 7
    CHECK = 8
    D0 = 9                 # digits 0..9 -> ids 9..18
    VOCAB = 32             # a few unused ids as slack

    @staticmethod
    def digit(d: int) -> int:
        return Tokens.D0 + int(d)

    @staticmethod
    def is_digit(t) -> bool:
        return Tokens.D0 <= t < Tokens.D0 + 10


@dataclasses.dataclass(frozen=True)
class ChainTask:
    min_k: int = 2
    max_k: int = 9
    max_extra: int = 14         # max verification lines (overthinking)
    p_early: float = 0.3        # premature-exit training mixture
    seq_len: int = 128

    # ----------------------------------------------------------- instance
    def sample_instance(self, rng: np.random.Generator, k: int | None = None) -> dict:
        if k is None:
            k = int(rng.integers(self.min_k, self.max_k + 1))
        e = rng.integers(0, 10, size=k)
        s = np.zeros(k + 1, np.int64)
        for i in range(1, k + 1):
            s[i] = (e[i - 1] + 2 * s[i - 1]) % 10
        return {"k": k, "e": e, "s": s, "answer": int(s[k])}

    def prompt_tokens(self, inst: dict) -> list[int]:
        T = Tokens
        return [T.Q, T.digit(inst["k"])] + [T.digit(x) for x in inst["e"]] + [T.BEGIN_THINK]

    def step_line(self, i: int, s_i: int) -> list[int]:
        T = Tokens
        return [T.STEP, T.digit(i % 10), T.digit(s_i), T.NEWLINE]

    def check_line(self, j: int, s_j: int) -> list[int]:
        T = Tokens
        return [T.CHECK, T.digit(j % 10), T.digit(s_j), T.NEWLINE]

    # ----------------------------------------------------------- training
    def sample_sequence(self, rng: np.random.Generator) -> np.ndarray:
        T = Tokens
        inst = self.sample_instance(rng)
        k, s = inst["k"], inst["s"]
        toks = self.prompt_tokens(inst)
        if rng.random() < self.p_early and k > 1:
            j = int(rng.integers(0, k))          # premature exit after j lines
            for i in range(1, j + 1):
                toks += self.step_line(i, s[i])
        else:
            for i in range(1, k + 1):
                toks += self.step_line(i, s[i])
            extra = int(rng.integers(0, self.max_extra + 1))
            for _ in range(extra):
                j = int(rng.integers(1, k + 1))
                toks += self.check_line(j, s[j])
        toks += [T.END_THINK, T.ANS, T.digit(inst["answer"]), T.EOS]
        arr = np.full(self.seq_len, T.PAD, np.int32)
        arr[: min(len(toks), self.seq_len)] = toks[: self.seq_len]
        return arr

    def batch(self, rng: np.random.Generator, batch_size: int) -> dict:
        seqs = np.stack([self.sample_sequence(rng) for _ in range(batch_size)])
        tokens = seqs[:, :-1]
        targets = seqs[:, 1:]
        mask = (targets != Tokens.PAD).astype(np.float32)
        S = tokens.shape[1]
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), tokens.shape)
        return {
            "tokens": tokens,
            "targets": targets,
            "loss_mask": mask,
            "positions": pos.copy(),
            "pos1d": pos.copy(),
        }

    # ----------------------------------------------------------- serving
    def serve_batch(self, rng: np.random.Generator, batch_size: int,
                    k: int | None = None) -> dict:
        """Left-padded prompts + ground truth for the serving engine."""
        insts = [self.sample_instance(rng, k=k) for _ in range(batch_size)]
        prompts = [self.prompt_tokens(i) for i in insts]
        L = max(len(p) for p in prompts)
        out = np.full((batch_size, L), Tokens.PAD, np.int32)
        lens = np.zeros(batch_size, np.int32)
        for b, p in enumerate(prompts):
            out[b, L - len(p):] = p             # LEFT padding
            lens[b] = len(p)
        return {
            "prompts": out,
            "prompt_len": lens,
            "answers": np.array([i["answer"] for i in insts], np.int32),
            "k": np.array([i["k"] for i in insts], np.int32),
        }

    # ----------------------------------------------------------- metrics
    @staticmethod
    def extract_answer(rollout: np.ndarray) -> np.ndarray:
        """rollout: (B, n) forced-rollout tokens (starting after </think>).
        Returns (B,) digit (0..9) or -1 if malformed.  The canonical format
        is [ANS, digit, EOS, ...]; we scan for the first digit after ANS."""
        B, n = rollout.shape
        out = np.full(B, -1, np.int64)
        for b in range(B):
            seen_ans = False
            for t in rollout[b]:
                if t == Tokens.ANS:
                    seen_ans = True
                elif seen_ans and Tokens.is_digit(t):
                    out[b] = int(t) - Tokens.D0
                    break
                elif t == Tokens.EOS:
                    break
        return out
