"""Checks and launch plumbing shared by the ctypes kernel launchers."""
from __future__ import annotations

import torch

from . import build

DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def suffix(dtype: torch.dtype) -> str:
    """C entry suffix of a storage dtype; raises for any other dtype."""
    try:
        return DTYPES[dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or float64, got {dtype}") from None


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device; returns it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every operand must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
    return dev


def check_rows(name: str, t: torch.Tensor, n: int, m: int) -> int:
    """``t`` is (n, m) with unit column stride; returns its row stride."""
    if t.dim() != 2 or t.shape[0] != n or t.shape[1] != m:
        raise ValueError(f"{name}: expected shape ({n}, {m}), got {tuple(t.shape)}")
    if (m > 1 and t.stride(1) != 1) or t.stride(0) < m:
        raise ValueError(f"{name}: rows must hold contiguous entries (strides {t.stride()})")
    return t.stride(0)


def check_vector(name: str, t: torch.Tensor, n: int) -> int:
    """``t`` is (n,) with a positive stride; returns the stride."""
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: expected shape ({n},), got {tuple(t.shape)}")
    if t.stride(0) < 1:
        raise ValueError(f"{name}: expected a positive stride, got {t.stride(0)}")
    return t.stride(0)


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when the memory spans of ``a`` and ``b`` intersect."""
    def span(t):
        storage = t.untyped_storage()
        return storage.data_ptr(), storage.data_ptr() + storage.nbytes()
    (a0, a1), (b0, b1) = span(a), span(b)
    return a0 < b1 and b0 < a1


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def call(fn_name: str, *args) -> None:
    """Call a C entry point; raise when it reports a CUDA error."""
    rc = getattr(build.load().lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {rc}")


def reduce_blocks(n: int) -> int:
    """Rows of the per-block partial-sum scratch for n rows."""
    return build.load().lib.repro_reduce_blocks(n)
