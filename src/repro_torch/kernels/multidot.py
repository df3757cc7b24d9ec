"""CUDA launcher of the (K5) multi-dot kernel ``csrc/multidot.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.multidot.multidot``:
``out[k] = <W[:, k], z>`` for a lane-major window ``W (n, m)`` in one pass
over ``z``, accumulated in ``promote_types(dtype, f32)``.  ``W`` may be a
column view of a wider window and ``z`` a strided column: their strides
are passed to the kernel, nothing is copied.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _launch, build
from .ref import acc_dtype


def multidot(W: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``(m,)`` in the
    accumulation dtype."""
    sfx = _launch.suffix(W.dtype)
    if z.dtype != W.dtype:
        raise TypeError(f"multidot: W is {W.dtype} but z is {z.dtype}")
    dev = _launch.check_cuda("multidot", W, z)
    n, m = W.shape if W.dim() == 2 else (-1, -1)
    ldw = _launch.check_rows("multidot W", W, n, m)
    ldz = _launch.check_vector("multidot z", z, n)
    if not 1 <= m <= build.load().lib.repro_max_width():
        raise ValueError(f"multidot: window width {m} outside the built range")
    acc = acc_dtype(W.dtype)
    partial = torch.empty(_launch.reduce_blocks(n) * m, dtype=acc, device=dev)
    out = torch.empty(m, dtype=acc, device=dev)
    _launch.call(f"repro_multidot_{sfx}", W.data_ptr(), ldw, z.data_ptr(), ldz, n, m,
                 partial.data_ptr(), out.data_ptr(), _launch.stream(dev))
    LAUNCHES["multidot"] += 1
    return out
