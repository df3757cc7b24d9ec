"""CUDA launcher of the fused p(l)-CG body kernel ``csrc/fused_body.cu``.

Replaces the Pallas TPU megakernel ``repro.kernels.fused_body.fused_body``:
one launch per body computes the (K1) 5-point SPMV on ``Zw[:, 0]`` (with
``stencil_hw``) or reads a streamed ``t``, the (K4) v/z window recurrences
(warmup or steady on the packed ``steady`` flag) and the (K5) 2l+1 payload
dots against the updated windows.  Scalars arrive packed on the device as
``scal (1, 7+2l) = [steady, s_warm, gam, dlt, dsub, gcc, invd, g_0..g_{2l-1}]``.

The kernel writes the new windows into separate output buffers (other
blocks read ``Zw[:, 0]`` as stencil neighbours while it runs), so ``out``
must not overlap the inputs; the engine ping-pongs two window pairs.
The zhat window and the in-body diagonal preconditioner wait for ROADMAP
A.6.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, _launch, build
from .ref import acc_dtype

#: scal layout: [steady, s_warm, gam, dlt, dsub, gcc, invd, g_0 .. g_{2l-1}]
N_FIXED_SCALARS = 7


def fused_body(Vw: torch.Tensor, Zw: torch.Tensor, scal: torch.Tensor,
               t: Optional[torch.Tensor], *, l: int, stencil_hw=None,
               out: Optional[tuple] = None):
    """Launch the kernel on CUDA tensors; returns ``(Vw2, Zw2, dots)`` with
    ``dots (2l+1,)`` in the accumulation dtype."""
    sfx = _launch.suffix(Vw.dtype)
    if not 1 <= l <= build.load().lib.repro_max_depth():
        raise ValueError(f"fused_body: l={l} outside the built range")
    n = Vw.shape[0]
    m = 2 * l + 1
    acc = acc_dtype(Vw.dtype)
    operands = [Vw, Zw, scal] + ([t] if t is not None else [])
    dev = _launch.check_cuda("fused_body", *operands)
    for name, x, shape, dtype in (("Vw", Vw, (n, m), Vw.dtype), ("Zw", Zw, (n, l + 1), Vw.dtype),
                                  ("scal", scal, (1, N_FIXED_SCALARS + 2 * l), acc)):
        if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"fused_body: {name} must be a contiguous {shape} {dtype} "
                             f"tensor, got {tuple(x.shape)} {x.dtype}")
    if t is None:
        if stencil_hw is None:
            raise ValueError("fused_body: pass the streamed t or stencil_hw")
        H, W2d = stencil_hw
        if H * W2d != n:
            raise ValueError(f"fused_body: stencil_hw {stencil_hw} != n={n}")
    else:
        if stencil_hw is not None:
            raise ValueError("fused_body: t is computed in-kernel with stencil_hw; pass t=None")
        if tuple(t.shape) != (n,) or t.dtype != Vw.dtype or not t.is_contiguous():
            raise ValueError(f"fused_body: t must be a contiguous ({n},) {Vw.dtype} tensor")
        H = W2d = 0
    Vo, Zo = out if out is not None else (torch.empty_like(Vw), torch.empty_like(Zw))
    for name, o, x in (("Vw2", Vo, Vw), ("Zw2", Zo, Zw)):
        if o.shape != x.shape or o.dtype != x.dtype or not o.is_contiguous() or o.device != dev:
            raise ValueError(f"fused_body: output {name} must match its input window")
        if any(_launch.overlaps(o, src) for src in operands):
            raise ValueError(f"fused_body: output {name} overlaps an input")
    if _launch.overlaps(Vo, Zo):
        raise ValueError("fused_body: the two output windows overlap")
    partial = torch.empty(_launch.reduce_blocks(n) * m, dtype=acc, device=dev)
    dots = torch.empty(m, dtype=acc, device=dev)
    _launch.call(f"repro_fused_body_{sfx}", Vw.data_ptr(), Zw.data_ptr(), scal.data_ptr(),
                 None if t is None else t.data_ptr(), n, l, H, W2d, Vo.data_ptr(),
                 Zo.data_ptr(), partial.data_ptr(), dots.data_ptr(), _launch.stream(dev))
    LAUNCHES["fused_body"] += 1
    return Vo, Zo, dots
