"""The training path and the kernels' autograd guard on the card.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_cuda.py

* Each kernel wrapper (flash, paged, entropy, SSD scan, flash-decode)
  raises a ``RuntimeError`` naming its op when grad mode is on and an input
  requires grad, instead of returning a result with no ``grad_fn``; under
  ``torch.no_grad()`` the same call runs the kernel.
* 3 ``tiny`` float32 train steps on the card equal the same steps on the
  CPU within 1e-5 (losses, metrics, every parameter after), TF32 off.
* A checkpoint saved from card tensors (float32 ``tiny``, bfloat16 reduced
  ``qwen3-1.7b``) reloads onto the card bitwise.
"""
import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels and the card's training path "
                    "need the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(name):
    """(wrapper, kwargs, the input made to require grad) at small shapes
    (chip_smoke.py's case builders)."""
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.entropy_probe import ops as ep
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd_scan import ops as ss

    f32 = torch.float32
    if name == "flash_attention":
        kw = cs.flash_case(torch, f32, B=2, S=64, Hq=4, Hkv=2, D=32)
        return fa.flash_attention_cuda, dict(kw, scale=0.2), "q"
    if name == "paged_attention":
        kw, _ = cs.paged_case(torch, pa, f32, 1, B=2, Hq=4, Hkv=2, D=32, n_mapped=12)
        return pa.paged_attention_cuda, dict(kw, scale=0.2), "k_pool"
    if name == "entropy_probe":
        return ep.entropy_probe_cuda, cs.entropy_case(torch, f32, 2, 64, 512, 500,
                                                      False), "w"
    if name == "ssd_scan":
        kw = cs.ssd_case(torch, B=1, S=32, nh=4, hp=16, N=16)
        return ss.ssd_scan_cuda, dict(kw, chunk=16), "u"
    kw = cs.decode_case(torch, f32, 1, B=2, C=256, Hq=4, Hkv=2, D=32)
    return da.decode_attention_cuda, dict(kw, scale=0.2), "v"


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "entropy_probe", "ssd_scan", "decode_attention"])
def test_kernel_refuses_autograd(cuda, name):
    fn, kw, leaf = _case(name)
    kw[leaf] = kw[leaf].detach().requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
        fn(**kw)
    with torch.no_grad():
        out = fn(**kw)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is None and bool(torch.isfinite(out).all())


def _steps(cfg, params, device, n=3):
    from repro_torch.data.pipeline import device_put_batch, train_batches
    from repro_torch.data.synthetic import ChainTask
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig, TrainState,
                                                 make_train_step, trainable)

    params = trainable(params)
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, TrainConfig(
        opt=AdamWConfig(lr=2e-3, warmup_steps=1, total_steps=10)))
    metrics = []
    for _, b in zip(range(n), train_batches(ChainTask(seq_len=64), 8, seed=0)):
        state, m = step(state, device_put_batch(b, device))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state.params


def test_train_steps_on_the_card_equal_the_cpu(cuda):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.params import to_jax, unstack
    from repro_torch.utils.treeutil import tree_flatten_with_paths

    cfg = get_config("tiny")
    host = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = unstack(to_jax(host, cfg), cfg, cuda)
    m_cpu, p_cpu = _steps(cfg, host, "cpu")
    m_gpu, p_gpu = _steps(cfg, card, cuda)
    for a, b in zip(m_gpu, m_cpu):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-5), k
    for (path, a), (_, b) in zip(tree_flatten_with_paths(p_gpu),
                                 tree_flatten_with_paths(p_cpu)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-5,
                                   atol=1e-5, msg=path)


@pytest.mark.parametrize("name", ["tiny", "qwen3-reduced-bf16"])
def test_checkpoint_from_the_card_reloads_bitwise(cuda, name, tmp_path):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.utils.treeutil import tree_flatten_with_paths

    cfg = get_config("tiny") if name == "tiny" else dataclasses.replace(
        get_config("qwen3-1.7b").reduced(), dtype="bfloat16")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(1), device=cuda)
    path = str(tmp_path / "card.ckpt")
    save_checkpoint(path, params, cfg)
    back = load_checkpoint(path, cfg, device=cuda)
    for (p, a), (_, b) in zip(tree_flatten_with_paths(back),
                              tree_flatten_with_paths(params)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b), p
