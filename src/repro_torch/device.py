"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device="cuda"`` request without a visible GPU raises instead of quietly
running somewhere else.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
