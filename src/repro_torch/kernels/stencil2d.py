"""CUDA launcher of the (K1) stencil kernel ``csrc/stencil2d.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.stencil2d.stencil2d``:
``y = 4x - x_N - x_S - x_W - x_E`` on an ``(H, W)`` block, with the halo
rows ``halo_n``/``halo_s`` ``(W,)`` and the halo columns
``halo_w``/``halo_e`` ``(H,)`` standing in for the neighbours outside it,
accumulated in ``promote_types(dtype, f32)``.  ``x`` and the halos are
read through their strides (the engine passes the window column
``Zw[:, 0]`` viewed as ``(H, W)``); ``y`` is a new contiguous tensor.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _launch


def stencil2d(x: torch.Tensor, halo_n: torch.Tensor, halo_s: torch.Tensor,
              halo_w: torch.Tensor, halo_e: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``(H, W)`` in x's dtype."""
    sfx = _launch.suffix(x.dtype)
    if x.dim() != 2:
        raise ValueError(f"stencil2d: x must be (H, W), got {tuple(x.shape)}")
    H, W = x.shape
    dev = _launch.check_cuda("stencil2d", x, halo_n, halo_s, halo_w, halo_e)
    strides = []
    for name, h, m in (("halo_n", halo_n, W), ("halo_s", halo_s, W), ("halo_w", halo_w, H),
                       ("halo_e", halo_e, H)):
        if h.dtype != x.dtype:
            raise TypeError(f"stencil2d: x is {x.dtype} but {name} is {h.dtype}")
        strides.append(_launch.check_vector(f"stencil2d {name}", h, m))
    if H < 1 or W < 1 or min(x.stride()) < 1:
        raise ValueError(f"stencil2d: x must be non-empty with positive strides, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    y = torch.empty((H, W), dtype=x.dtype, device=dev)
    _launch.call(f"repro_stencil2d_{sfx}", x.data_ptr(), x.stride(0), x.stride(1),
                 halo_n.data_ptr(), strides[0], halo_s.data_ptr(), strides[1],
                 halo_w.data_ptr(), strides[2], halo_e.data_ptr(), strides[3], H, W,
                 y.data_ptr(), _launch.stream(dev))
    LAUNCHES["stencil2d"] += 1
    return y
