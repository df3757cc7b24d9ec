"""CUDA launcher of the (K4) sliding-window AXPY kernel ``csrc/window_axpy.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.window_axpy.window_axpy``:
``v = (z - V g) / gcc`` for a lane-major window ``V (n, m)``.  ``g`` and
``gcc`` stay on the device: they ride one ``(m+1,)`` operand
``[g_0..g_{m-1}, gcc]`` that the kernel reads from device memory.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _launch, build
from .ref import acc_dtype


def window_axpy(V: torch.Tensor, z: torch.Tensor, g: torch.Tensor,
                gcc: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``(n,)`` in V's dtype.
    ``gcc`` is a 0-d tensor on the same device."""
    sfx = _launch.suffix(V.dtype)
    if z.dtype != V.dtype:
        raise TypeError(f"window_axpy: V is {V.dtype} but z is {z.dtype}")
    dev = _launch.check_cuda("window_axpy", V, z, g, gcc)
    n, m = V.shape if V.dim() == 2 else (-1, -1)
    ldv = _launch.check_rows("window_axpy V", V, n, m)
    ldz = _launch.check_vector("window_axpy z", z, n)
    if g.shape != (m,) or gcc.dim() != 0:
        raise ValueError(f"window_axpy: expected g ({m},) and a 0-d gcc, got "
                         f"{tuple(g.shape)} and {tuple(gcc.shape)}")
    if not 1 <= m <= build.load().lib.repro_max_width():
        raise ValueError(f"window_axpy: window width {m} outside the built range")
    acc = acc_dtype(V.dtype)
    coef = torch.cat([g.to(acc), gcc.to(acc).reshape(1)])
    out = torch.empty(n, dtype=V.dtype, device=dev)
    _launch.call(f"repro_window_axpy_{sfx}", V.data_ptr(), ldv, z.data_ptr(), ldz,
                 coef.data_ptr(), n, m, out.data_ptr(), _launch.stream(dev))
    LAUNCHES["window_axpy"] += 1
    return out
