"""EAT — Entropy After ``</think>`` (port of ``repro/core/eat.py``; paper
§4.1).  The probe is a forward over the probe-token suffix against the live
decode cache that commits nothing (``Model.probe_entropy``); the entropy is
the fused ``entropy_probe`` kernel."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.models.common import positions_for


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """The token suffix appended (virtually) for an EAT evaluation:
    ``tokens[0]`` is ``</think>``, the rest the optional answer prefix
    (paper Eq. 13)."""

    tokens: tuple[int, ...]

    def __len__(self) -> int:
        return len(self.tokens)


def make_probe(end_think_id: int, prefix_ids: Sequence[int] = ()) -> ProbeSpec:
    return ProbeSpec(tokens=(end_think_id, *prefix_ids))


def eval_eat(model, cache, probe: ProbeSpec, next_pos: torch.Tensor, *,
             entropy_impl: str = "auto") -> torch.Tensor:
    """Batched EAT for every sequence sharing the cache.  (B,) float32.
    The probe tokens take positions next_pos + [0..m) (M-RoPE's three
    streams all these, ``positions_for``); nothing is committed."""
    B = next_pos.shape[0]
    m = len(probe)
    # one fill per token: a host-to-device copy would synchronise the host
    toks = torch.stack([torch.full((B,), t, dtype=torch.long,
                                   device=next_pos.device)
                        for t in probe.tokens], 1)
    pos1d = (next_pos[:, None]
             + torch.arange(m, dtype=torch.int32, device=next_pos.device)[None, :])
    return model.probe_entropy(toks, positions_for(model.cfg, pos1d), pos1d, cache,
                               entropy_impl=entropy_impl)


def entropy_of_logits(logits: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """The plain entropy (Eq. 2) over (..., V) logits, in float32,
    restricted to ``[:vocab]`` when the table is padded."""
    lf = logits.float()
    if vocab is not None and vocab < lf.shape[-1]:
        keep = torch.arange(lf.shape[-1], device=lf.device) < vocab
        lf = torch.where(keep, lf, -torch.inf)
    logp = torch.log_softmax(lf, dim=-1)
    p = torch.exp(logp)
    return -torch.where(p > 0, p * logp, 0.0).sum(-1)
