"""Plain PyTorch versions of every kernel (port of ``repro.kernels.ref``).

They are the CPU path of the kernel wrappers in ``ops.py`` and the ground
truth the CUDA kernels are held against on the card.  Window arguments are
**lane-major** ``(n, window)``; accumulation is
``promote_types(dtype, float32)`` exactly like the kernels (f32 accumulates
in f32, f64 stays f64).
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the kernels: ``promote_types(dtype, f32)``."""
    return torch.promote_types(dtype, torch.float32)


def stencil2d_ref(x, halo_n, halo_s, halo_w, halo_e):
    """y = 4x - x_N - x_S - x_W - x_E on an (H, W) block with halos."""
    acc = acc_dtype(x.dtype)
    xa = x.to(acc)
    up = torch.cat([halo_n.reshape(1, -1).to(acc), xa[:-1]], 0)
    down = torch.cat([xa[1:], halo_s.reshape(1, -1).to(acc)], 0)
    left = torch.cat([halo_w.reshape(-1, 1).to(acc), xa[:, :-1]], 1)
    right = torch.cat([xa[:, 1:], halo_e.reshape(-1, 1).to(acc)], 1)
    return (4.0 * xa - up - down - left - right).to(x.dtype)


def multidot_ref(W, z):
    """out (m,) = W.T @ z for lane-major W (n, m), in the accumulation dtype."""
    acc = acc_dtype(W.dtype)
    return (W.to(acc) * z.to(acc)[:, None]).sum(dim=0)


def window_axpy_ref(V, z, g, gcc):
    """v_new (n,) = (z - V @ g) / gcc for lane-major V (n, m), in V's dtype."""
    acc = acc_dtype(V.dtype)
    out = z.to(acc) - (V.to(acc) * g.to(acc)[None, :]).sum(dim=1)
    return (out / gcc).to(V.dtype)


def fused_body_ref(Vw, Zw, t, *, l, steady, s_warm, gam, dlt, dsub, gcc, g,
                   stencil_hw=None):
    """Plain version of the fused p(l)-CG body (``fused_body``).

    With ``stencil_hw`` the 5-point Dirichlet stencil is applied to
    ``Zw[:, 0]`` in place of a streamed ``t`` (the SPMV stream is rounded
    to the storage dtype).  The v-recurrence runs only when ``steady``;
    the z-recurrence takes its warmup form ``t - s_warm z_0`` otherwise.
    Payload dots read the updated windows as stored.  Returns
    ``(Vw2, Zw2, dots)`` with ``dots = [vd_0..vd_l, zd_0..zd_{l-1}]``.
    (The zhat window and the in-body diagonal preconditioner of the
    reference wait for ROADMAP A.6.)
    """
    acc = acc_dtype(Vw.dtype)
    V = Vw.to(acc)
    Z = Zw.to(acc)
    if t is None:
        if stencil_hw is None:
            raise ValueError("fused_body_ref needs t or stencil_hw")
        H, W2d = stencil_hw
        x = Z[:, 0].reshape(H, W2d)
        zr = torch.zeros_like
        t = stencil2d_ref(x, zr(x[0]), zr(x[0]), zr(x[:, 0]),
                          zr(x[:, 0])).reshape(-1).to(Zw.dtype).to(acc)
    t = t.to(acc)[:, None]
    steady = torch.as_tensor(steady, device=Vw.device)
    g = torch.as_tensor(g, device=Vw.device).to(acc)
    vnew = (Z[:, l - 1:l] - (V[:, :2 * l] * g[None, :]).sum(dim=1, keepdim=True)) / gcc
    V2 = torch.where(steady, torch.cat([vnew, V[:, :-1]], dim=1), V)
    znew = torch.where(steady, (t - gam * Z[:, :1] - dsub * Z[:, 1:2]) / dlt,
                       t - s_warm * Z[:, :1])
    Z2 = torch.cat([znew, Z[:, :-1]], dim=1)
    lhs = znew
    vd = (V2.to(Vw.dtype).to(acc)[:, :l + 1] * lhs).sum(dim=0)
    zd = (Z2.to(Zw.dtype).to(acc)[:, :l] * lhs).sum(dim=0)
    return V2.to(Vw.dtype), Z2.to(Zw.dtype), torch.cat([vd, zd])
