"""Which flash kernel the port launches: ``flash_variant``'s rule, on the CPU.

bf16 at an instantiated (Dk, Dv) pair takes the tensor-core kernel
(``"mma"``); float32, whose tensor-core products would be TF32, and bf16
head dims outside the set take the scalar kernel.  The kernels themselves
run only on the card (``tests/test_torch_cuda.py``, marker ``gpu``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.kernels.flash_attention import ops as fa

CU = Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
ATTENTION_CONFIGS = sorted(n for n, c in REGISTRY.items() if c.arch_type != "ssm")


@pytest.mark.parametrize("name", ATTENTION_CONFIGS)
def test_every_attention_config_routes_by_its_dtype(name):
    cfg = REGISTRY[name]
    hd = cfg.resolved_head_dim
    want = "mma" if cfg.dtype == "bfloat16" else "scalar"
    assert fa.flash_variant(cfg.dtype, hd, hd) == want


def test_the_served_bf16_configs_take_the_tensor_cores():
    for name in ("eat-paper-8b", "qwen3-1.7b"):
        cfg = get_config(name)
        assert cfg.dtype == "bfloat16"
        hd = cfg.resolved_head_dim
        assert fa.flash_variant(cfg.dtype, hd, hd) == "mma"
    for name in ("tiny", "tiny-proxy", "tiny-reasoner"):
        cfg = get_config(name)
        assert fa.flash_variant(cfg.dtype, cfg.resolved_head_dim,
                                cfg.resolved_head_dim) == "scalar"


@pytest.mark.parametrize("dtype,dk,dv,want", [
    (torch.bfloat16, 80, 80, "scalar"),       # outside the instantiated set
    (torch.bfloat16, 256, 256, "scalar"),
    (torch.bfloat16, 64, 96, "scalar"),       # (96, 64) is, (64, 96) is not
    (torch.float32, 128, 128, "scalar"),      # TF32 would miss the f32 bar
    (torch.float16, 128, 128, "scalar"),
    (torch.bfloat16, 128, 128, "mma"),
    (torch.bfloat16, 96, 64, "mma"),
    ("bfloat16", 16, 16, "mma"),
    ("float32", 16, 16, "scalar"),
])
def test_flash_variant_boundaries(dtype, dk, dv, want):
    assert fa.flash_variant(dtype, dk, dv) == want


def test_instantiated_pairs_match_the_source():
    """The C entry point instantiates exactly the pairs the rule routes to
    it, each a multiple of 16 up to 128."""
    pairs = {(int(a), int(b)) for a, b in
             re.findall(r"^\s*REPRO_MMA_CASE\((\d+), (\d+)\)", CU.read_text(), re.M)}
    assert pairs == set(fa.MMA_HEAD_DIMS)
    assert all(d % 16 == 0 and 16 <= d <= 128 for pair in pairs for d in pair)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(1, 8, 4, 128)), dtype=torch.bfloat16)
    k = torch.as_tensor(rng.normal(size=(1, 8, 2, 128)), dtype=torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32)[None]
    before = (fa.flash_attention_cuda.launches,
              dict(fa.flash_attention_cuda.variant_launches))
    out = fa.attention(q, k, k, pos, pos)
    torch.testing.assert_close(out, fa.attention_plain(q, k, k, pos, pos,
                                                       scale=128 ** -0.5),
                               atol=0, rtol=0)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_cuda.variant_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.attention(q, k, k, pos, pos, impl="cuda")
