"""Device dispatch of the kernels (port of ``repro.kernels.ops``).

Each ``*_apply`` takes the plain PyTorch version (``ref``) for a tensor on
the CPU and launches the hand-written CUDA kernel for a tensor on a CUDA
device; any other device raises.  There is no fallback: a CUDA tensor the
kernel does not take raises.

Window arguments are lane-major ``(n, window)`` throughout.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import ref
from .fused_body import N_FIXED_SCALARS, fused_body
from .multidot import multidot
from .window_axpy import window_axpy


def _route(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"kernel operands must all be on the CPU or all on CUDA, got {kinds}")


def multidot_apply(W, z):
    """``out (m,) = W.T @ z`` for lane-major ``W (n, m)``, accumulation dtype."""
    if _route(W, z) == "cpu":
        return ref.multidot_ref(W, z)
    return multidot(W, z)


def window_axpy_apply(V, z, g, gcc):
    """``v (n,) = (z - V @ g) / gcc`` for lane-major ``V (n, m)``, V's dtype;
    ``gcc`` is a 0-d tensor."""
    if _route(V, z, g, gcc) == "cpu":
        return ref.window_axpy_ref(V, z, g, gcc)
    return window_axpy(V, z, g, gcc)


@functools.lru_cache(maxsize=64)
def _constant(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d device constant, made once (no fill launch per body)."""
    return torch.full((), value, dtype=dtype, device=device)


def _pack_scalars(*, l, steady, s_warm, gam, dlt, dsub, gcc, g, dtype, device) -> torch.Tensor:
    """The ``(1, 7+2l)`` operand ``[steady, s_warm, gam, dlt, dsub, gcc,
    invd, g_0..g_{2l-1}]`` built on the device in one launch (Python
    numbers become cached device constants; ``invd`` is 0 here)."""
    fixed = [1.0 if steady else 0.0, s_warm, gam, dlt, dsub, gcc, 0.0]
    parts = [(_constant(float(v), dtype, device) if not isinstance(v, torch.Tensor)
              else v.to(dtype)).reshape(1) for v in fixed]
    return torch.cat(parts + [g.to(dtype)]).reshape(1, N_FIXED_SCALARS + 2 * l)


def fused_body_apply(Vw, Zw, t, *, l, steady: bool, s_warm, gam, dlt, dsub, gcc, g,
                     stencil_hw=None, out: Optional[tuple] = None):
    """One fused p(l)-CG body step (see ``fused_body``): returns
    ``(Vw2, Zw2, dots)``.  ``steady`` is a host bool (the engine knows the
    phase); the other scalars are 0-d tensors or Python numbers.  ``out``
    optionally names the two buffers that receive the new windows."""
    if _route(Vw, Zw, t) == "cpu":
        V2, Z2, dots = ref.fused_body_ref(Vw, Zw, t, l=l, steady=steady, s_warm=s_warm,
                                          gam=gam, dlt=dlt, dsub=dsub, gcc=gcc, g=g,
                                          stencil_hw=stencil_hw)
        if out is not None:
            out[0].copy_(V2)
            out[1].copy_(Z2)
            V2, Z2 = out
        return V2, Z2, dots
    acc = ref.acc_dtype(Vw.dtype)
    scal = _pack_scalars(l=l, steady=steady, s_warm=s_warm, gam=gam, dlt=dlt, dsub=dsub,
                        gcc=gcc, g=g, dtype=acc, device=Vw.device)
    return fused_body(Vw, Zw, scal, t, l=l, stencil_hw=stencil_hw, out=out)
