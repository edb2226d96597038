"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes`` — seconds per kernel, against minutes for a build that includes
PyTorch's headers.  Libraries are built on first use into ``_build/`` beside
the package sources (listed in ``.gitignore``) under a name that carries a
hash of the source and the flags, so an edited source never loads a stale
library.  ``build`` compiles several sources in parallel, one ``nvcc`` each.

Every C entry point returns the ``cudaError_t`` of its launch; ``check``
turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("flash_attention", "paged_attention", "entropy_probe", "ssd_scan",
           "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each kernel built in
#: this process
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes started together.  Returns seconds per kernel built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    times = {}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc rc {proc.returncode})\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for kernel ``name`` (built on first use), with
    ``argtypes`` set from ``signatures`` and every ``restype`` an int."""
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` -> the kernel for CUDA tensors, the plain version for CPU
    tensors; ``cuda`` on a CPU tensor raises (there is no fallback)."""
    if impl == "auto":
        return "cuda" if x.is_cuda else "plain"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{x.device}")
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r} (auto/cuda/plain)")
    return impl


def no_autograd(op: str, *tensors) -> None:
    """Refuse to run ``op`` under autograd.  A kernel writes its result
    into a fresh buffer through a raw pointer, so the output would carry no
    ``grad_fn``: the gradients of everything upstream would be cut without
    an error.  No kernel of the port has a backward (nor has any in the
    reference); training runs the plain versions."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: an input requires grad, and the CUDA kernel has no "
            f"backward; run it under torch.no_grad() or call the plain "
            f"version (impl='plain'), which autograd differentiates")


def dtype_code(x: torch.Tensor) -> int:
    """The kernels' element-type switch: 0 = float32, 1 = bfloat16."""
    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {x.dtype}")


def expect(x: torch.Tensor, dtype, ndim: int, name: str) -> None:
    """Wrapper-side argument check: a contiguous CUDA tensor of ``dtype``
    and rank ``ndim``."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def stream_ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
