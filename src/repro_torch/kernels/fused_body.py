"""CUDA launcher of the fused p(l)-CG body kernel ``csrc/fused_body.cu``.

Replaces the Pallas TPU megakernel ``repro.kernels.fused_body.fused_body``:
one launch per body computes the (K1) 5-point SPMV on ``Zw[:, 0]`` (with
``stencil_hw``) or reads a streamed ``t`` / ``t_hat``, the in-body diagonal
preconditioner ``t = invd * t_hat`` (``invd`` a scalar riding the packed
scalars, or an ``(n,)`` operand), the (K4) v/z window recurrences and,
with the zhat window ``Zhw (n, 3)``, the zhat recurrence (warmup or steady
on the packed ``steady`` flag), and the (K5) 2l+1 payload dots against the
updated windows -- against ``zhat_new`` when ``Zhw`` is given.  Scalars
arrive packed on the device as
``scal (1, 7+2l) = [steady, s_warm, gam, dlt, dsub, gcc, invd, g_0..g_{2l-1}]``.

The kernel writes the new windows into separate output buffers (other
blocks read ``Zw[:, 0]`` as stencil neighbours while it runs), so ``out``
must not overlap any input; the engine ping-pongs two window sets.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, _launch, build
from .ref import acc_dtype

#: scal layout: [steady, s_warm, gam, dlt, dsub, gcc, invd, g_0 .. g_{2l-1}]
N_FIXED_SCALARS = 7
_DIAG_CODE = {"none": 0, "scalar": 1, "vector": 2}


def _check_operand(name: str, x: torch.Tensor, shape: tuple, dtype: torch.dtype) -> None:
    if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"fused_body: {name} must be a contiguous {shape} {dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")


def fused_body(Vw: torch.Tensor, Zw: torch.Tensor, Zhw: Optional[torch.Tensor],
               scal: torch.Tensor, t: Optional[torch.Tensor], t_hat: Optional[torch.Tensor],
               invd: Optional[torch.Tensor], *, l: int, diag: str, stencil_hw=None,
               out: Optional[tuple] = None):
    """Launch the kernel on CUDA tensors; returns ``(Vw2, Zw2, Zhw2 | None,
    dots)`` with ``dots (2l+1,)`` in the accumulation dtype.  The caller
    (``ops.fused_body_apply``) has validated the operand combination with
    ``ref.fused_body_diag``, which gave ``diag`` ("scalar" reads
    ``scal[6]``, "vector" the ``(n,)`` ``invd``); ``out`` optionally names
    the buffers that receive the new windows."""
    sfx = _launch.suffix(Vw.dtype)
    if not 1 <= l <= build.load().lib.repro_max_depth():
        raise ValueError(f"fused_body: l={l} outside the built range")
    n = Vw.shape[0]
    m = 2 * l + 1
    dt = Vw.dtype
    acc = acc_dtype(dt)
    inputs = {"Vw": Vw, "Zw": Zw, "Zhw": Zhw, "scal": scal, "t": t, "t_hat": t_hat,
              "invd": invd}
    operands = [x for x in inputs.values() if x is not None]
    dev = _launch.check_cuda("fused_body", *operands)
    shapes = {"Vw": ((n, m), dt), "Zw": ((n, l + 1), dt), "Zhw": ((n, 3), dt),
              "scal": ((1, N_FIXED_SCALARS + 2 * l), acc), "t": ((n,), dt),
              "t_hat": ((n,), dt), "invd": ((n,), dt)}
    for name, x in inputs.items():
        if x is not None:
            _check_operand(name, x, *shapes[name])
    H, W2d = stencil_hw if stencil_hw is not None else (0, 0)
    windows = [Vw, Zw] + ([Zhw] if Zhw is not None else [])
    outs = list(out) if out is not None else [torch.empty_like(x) for x in windows]
    if len(outs) != len(windows):
        raise ValueError(f"fused_body: out must name {len(windows)} window buffers")
    for name, o, x in zip(("Vw2", "Zw2", "Zhw2"), outs, windows):
        if o.shape != x.shape or o.dtype != x.dtype or not o.is_contiguous() or o.device != dev:
            raise ValueError(f"fused_body: output {name} must match its input window")
        if any(_launch.overlaps(o, src) for src in operands):
            raise ValueError(f"fused_body: output {name} overlaps an input")
    if any(_launch.overlaps(a, b) for i, a in enumerate(outs) for b in outs[i + 1:]):
        raise ValueError("fused_body: the output windows overlap")
    Zho = outs[2] if Zhw is not None else None
    partial = torch.empty(_launch.reduce_blocks(n) * m, dtype=acc, device=dev)
    dots = torch.empty(m, dtype=acc, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    _launch.call(f"repro_fused_body_{sfx}", Vw.data_ptr(), Zw.data_ptr(), ptr(Zhw),
                 scal.data_ptr(), ptr(t), ptr(t_hat), ptr(invd), n, l, _DIAG_CODE[diag], H,
                 W2d, outs[0].data_ptr(), outs[1].data_ptr(), ptr(Zho), partial.data_ptr(),
                 dots.data_ptr(), _launch.stream(dev))
    LAUNCHES["fused_body"] += 1
    return outs[0], outs[1], Zho, dots

