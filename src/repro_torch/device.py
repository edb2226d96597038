"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device="cuda"`` request without a visible GPU raises instead of quietly
running somewhere else.  ``upload`` and ``upload_into`` move host arrays
to the card without making the host wait on the stream.
"""
from __future__ import annotations

import numpy as np
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


def upload(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on ``device``.  To the card it
    goes through pinned memory, the copy not blocking the host: the copy
    waits on the current stream like any other work, and the host does
    not wait on the stream (a copy from pageable memory would).  On the
    CPU the tensor shares the array's memory, as ``torch.as_tensor``
    does."""
    dev = torch.device(device)
    if isinstance(x, torch.Tensor) and x.device.type == dev.type:
        return x if dtype is None else x.to(dtype)
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if dtype is not None:
        t = t.to(dtype)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def upload_into(dst: torch.Tensor, x) -> torch.Tensor:
    """Copy the host array ``x`` into the tensor ``dst`` (as ``upload``:
    through pinned memory, not blocking the host, on the card)."""
    src = torch.as_tensor(np.asarray(x)).to(dst.dtype)
    if dst.is_cuda:
        return dst.copy_(src.pin_memory(), non_blocking=True)
    return dst.copy_(src)
