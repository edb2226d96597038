"""The one branch on device data in a decode chunk (the reference's
``lax.cond``, and the ``cond`` of its chunk ``lax.while_loop``).

``device_if(pred, then_fn, else_fn)`` reads ``bool(pred)`` on the host and
runs one branch.  Every host read of device data inside a decode chunk or a
proxy shadow chunk goes through it: the guard of each step (some row still
going) and the lazy EAT probe (some active row due).  ``device_if.calls``
counts those reads.  A chunk that the device runs without the host (CUDA
graphs with conditional nodes, as the reference's one-dispatch
``while_loop`` chunk) replaces exactly these calls.
"""
from __future__ import annotations

from typing import Callable

import torch


def device_if(pred: torch.Tensor, then_fn: Callable,
              else_fn: Callable | None = None):
    """``lax.cond(pred, then_fn, else_fn)`` on a 0-dim bool tensor: the
    output of the branch taken (None where ``else_fn`` is missing and
    ``pred`` is false).  One host read, counted in ``device_if.calls``."""
    device_if.calls += 1
    if bool(pred):
        return then_fn()
    return else_fn() if else_fn is not None else None


device_if.calls = 0
