"""Fine-grained mixture of experts (DeepSeek-style): shared experts plus
routed top-k experts (port of ``repro/models/moe.py``, its single-device
path: ``ctx.mesh is None``, every expert local).

* The router computes float32 logits ``x.float() @ router``, a softmax and
  the top k; the k weights are renormalised and scaled by ``routed_scale``.
  The load-balance loss is ``E * sum_e f_e * mean_e(probs)``, ``f`` the
  dispatch fraction (no gradient through it).
* Capacity: dropless (``cap = T``) when ``T * k <= 4096`` (decode and probe
  steps, small prefills), else ``ceil(T * k * cf / E)``; ``T`` is the
  call's whole ``B * S``, padding included, so a caller must keep the
  reference's ``(B, S)`` per call to keep and drop the same pairs.
* Dispatch (GShard, no sort): each (token, choice) pair in token-major
  order gets its position in its expert by a cumsum of the one-hot; pairs
  past the capacity go to a trash slot, and empty slots point at a zero
  row.  The experts run as batched matmuls over the ``(E, cap, d)`` buffer.
* Combine: the reference scatter-adds each token's k weighted rows into a
  zero row.  Here each token gathers its k rows by their slots (a dropped
  pair reads a zero row) and adds them in ascending slot order, which is
  the reference's update order (expert-major), each add rounded to the
  output dtype.  No atomics: the sum is the same in every call, so a
  CUDA-graph replay equals the eager call bitwise.

Every shape follows from ``(T, k, E, cf)`` on the host, and nothing reads
device data on the host (no ``.item()``, ``nonzero``, boolean-mask
indexing), so ``moe_apply`` can be captured in a CUDA graph.  The expert
matmuls are ``torch.bmm``: the reference computes them as einsums outside
any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, mlp_apply, mlp_init


def moe_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    """Seeded router (float32), routed experts ``(E, d_in, d_out)`` and the
    shared experts' MLP of width ``d_expert * n_shared``."""
    mo = cfg.moe
    E, d, f = mo.n_routed, cfg.d_model, mo.d_expert

    def experts(d_in: int, d_out: int) -> torch.Tensor:
        return torch.stack([dense_init(gen, d_in, d_out, dtype, device)
                            for _ in range(E)])

    p: dict = {
        "router": dense_init(gen, d, E, torch.float32, device),
        "experts": {"w_up": experts(d, f), "w_gate": experts(d, f),
                    "w_down": experts(f, d)},
    }
    if mo.n_shared:
        p["shared"] = mlp_init(gen, cfg, f * mo.n_shared, dtype, device)
    return p


def router_topk(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (weights (B, S, k) float32, expert ids (B, S, k)
    int64, aux loss 0-dim float32)."""
    mo = cfg.moe
    E = mo.n_routed
    logits = x.float() @ p["router"]                          # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, mo.top_k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    topw = topw * mo.routed_scale
    onehot = (topi[..., None] == torch.arange(E, device=x.device)).float()
    f = onehot.sum(dim=(0, 1, 2)) / (onehot.sum() + 1e-9)     # dispatch fraction
    pbar = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f * pbar)
    return topw, topi, aux


def _capacity(t: int, k: int, n_experts: int, cf: float) -> int:
    if t * k <= 4096:             # decode / small prefill: dropless
        return t
    return int(math.ceil(t * k * cf / n_experts))


def dispatch(topw: torch.Tensor, topi: torch.Tensor, n_experts: int, cap: int):
    """The GShard dispatch of ``(T, k)`` routing choices into ``n_experts *
    cap`` slots.  Returns ``(slot (T, k), buf_tok (E*cap,), buf_w (E*cap,)
    float32)``: each pair's slot (``E*cap``, the trash slot, where it is
    dropped), the token each slot holds (``T`` where empty) and its
    routing weight (0 where empty)."""
    T, k = topi.shape
    dev = topi.device
    n = n_experts * cap
    pair_e = topi.reshape(T * k)
    pair_t = torch.arange(T, device=dev).unsqueeze(1).expand(T, k).reshape(T * k)
    onehot = (pair_e[:, None] == torch.arange(n_experts, device=dev)).long()
    pos = torch.cumsum(onehot, dim=0) - 1                      # (T*k, E)
    pos_own = (pos * onehot).sum(dim=-1)                       # (T*k,)
    slot = torch.where(pos_own < cap, pair_e * cap + pos_own,
                       torch.full_like(pos_own, n))
    # the trash slot may be written by many dropped pairs: it is cut off
    buf_tok = torch.full((n + 1,), T, dtype=torch.long, device=dev)
    buf_tok = buf_tok.scatter(0, slot, pair_t)[:n]
    buf_w = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    buf_w = buf_w.scatter(0, slot, topw.reshape(T * k).float())[:n]
    return slot.reshape(T, k), buf_tok, buf_w


def expert_compute(x: torch.Tensor, topw, topi, experts, cfg: ModelConfig,
                   cap: int) -> torch.Tensor:
    """x: (T, d); topw/topi: (T, k).  The routed experts' weighted sum per
    token, (T, d) in the experts' dtype."""
    T, d = x.shape
    E = experts["w_up"].shape[0]
    slot, buf_tok, buf_w = dispatch(topw, topi, E, cap)
    x_pad = torch.cat([x, x.new_zeros(1, d)], dim=0)
    xg = x_pad[buf_tok].reshape(E, cap, d)
    h_up = torch.bmm(xg, experts["w_up"])
    if cfg.activation in ("silu", "geglu"):
        h_gate = torch.bmm(xg, experts["w_gate"])
        act = (F.silu(h_gate) if cfg.activation == "silu"
               else F.gelu(h_gate, approximate="tanh"))
        h = act * h_up
    else:
        h = F.gelu(h_up, approximate="tanh")
    yg = torch.bmm(h, experts["w_down"])                       # (E, cap, d)
    yflat = yg.reshape(E * cap, d) * buf_w[:, None].to(yg.dtype)
    return combine(yflat, slot)


def combine(yflat: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each token's k weighted rows of ``yflat`` (E*cap, d), gathered by
    their slots (T, k) and added in ascending slot order, each add rounded
    to ``yflat``'s dtype; a dropped pair (slot E*cap) adds a zero row."""
    y_pad = torch.cat([yflat, yflat.new_zeros(1, yflat.shape[1])], dim=0)
    rows = y_pad[torch.sort(slot, dim=-1).values]              # (T, k, d)
    out = rows[:, 0]
    for j in range(1, rows.shape[1]):
        out = out + rows[:, j]
    return out


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux loss 0-dim float32)."""
    mo = cfg.moe
    B, S, d = x.shape
    topw, topi, aux = router_topk(p, x, cfg)
    cap = _capacity(B * S, mo.top_k, mo.n_routed, mo.capacity_factor)
    y = expert_compute(x.reshape(B * S, d), topw.reshape(B * S, -1),
                       topi.reshape(B * S, -1), p["experts"], cfg,
                       cap).reshape(B, S, d)
    if mo.n_shared:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y, aux
