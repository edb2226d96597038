"""Host data pipeline (port of ``repro/data/pipeline.py``, one device): the
reference's batch iterator, and its batches moved to the device."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.synthetic import ChainTask
from repro_torch.device import upload


def train_batches(task: ChainTask, batch_size: int, seed: int = 0) -> Iterator[dict]:
    """Endless numpy batches of ``task``, the reference's bitwise (the same
    ``ChainTask`` and generator)."""
    rng = np.random.default_rng(seed)
    while True:
        yield task.batch(rng, batch_size)


def device_put_batch(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (``device.upload``:
    through pinned memory, not blocking the host, on the card), every key
    carried: a VLM batch's ``image_embeds`` (B, P, d) and (B, S_total, 3)
    M-RoPE ``positions``, and an encoder-decoder batch's ``frames`` (B, T,
    d), reach ``train_loss`` as they are."""
    return {k: upload(v, device) for k, v in batch.items()}
