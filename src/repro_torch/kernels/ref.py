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


#: the seven operand combinations of ``fused_body`` the reference admits:
#: name -> (in-kernel stencil, zhat window, diag mode); without the stencil
#: the kernel streams t (diag "none", no zhat), t and t_hat (diag "none"
#: with zhat) or t_hat alone (a diag mode)
FUSED_BODY_MODES = {
    "stencil": (True, False, "none"),
    "stencil+zh+scalar": (True, True, "scalar"),
    "stencil+zh+vector": (True, True, "vector"),
    "t": (False, False, "none"),
    "t+t_hat+zh": (False, True, "none"),
    "t_hat+zh+scalar": (False, True, "scalar"),
    "t_hat+zh+vector": (False, True, "vector"),
}


def fused_body_diag(n: int, l: int, Vw, Zhw, t, t_hat, invd, stencil_hw) -> str:
    """Validate a ``fused_body`` operand combination as the reference's
    ``fused_body`` does and return its diag mode: ``"none"``,
    ``"scalar"`` (0-d or Python ``invd``) or ``"vector"`` (``(n,)``).

    The seven admitted modes: stencil; stencil + zh + diag (scalar or
    vector); streamed t; streamed t + t_hat + zh; streamed t_hat + zh +
    diag (scalar or vector)."""
    if Vw.dim() != 2 or Vw.shape[1] != 2 * l + 1:
        raise ValueError(f"Vw must be (n, 2l+1), got {tuple(Vw.shape)} for l={l}")
    diag = ("none" if invd is None
            else "scalar" if not isinstance(invd, torch.Tensor) or invd.dim() == 0
            else "vector")
    if diag == "vector" and tuple(invd.shape) != (n,):
        raise ValueError(f"invd must be a scalar or ({n},), got {tuple(invd.shape)}")
    has_zh, has_stencil, has_diag = Zhw is not None, stencil_hw is not None, diag != "none"
    if has_diag and not has_zh:
        raise ValueError("in-kernel diag preconditioner needs the Zhw window")
    if has_stencil and has_zh and not has_diag:
        raise ValueError("in-kernel SPMV with a preconditioner requires the diag mode "
                         "(general prec => stream t/t_hat)")
    if has_stencil or has_diag:
        if t is not None:
            raise ValueError("t is computed in-kernel with the stencil/diag fused; pass t=None")
    elif t is None:
        raise ValueError("with nothing fused in-kernel (no stencil_hw, no invd) the "
                         "streamed t operand is required")
    if has_zh and not has_stencil and t_hat is None:
        raise ValueError("the zhat recurrence needs the streamed t_hat operand when the "
                         "stencil is not fused")
    if has_stencil and stencil_hw[0] * stencil_hw[1] != n:
        raise ValueError(f"stencil_hw {stencil_hw} != n={n}")
    return diag


def fused_body_ref(Vw, Zw, Zhw, t, t_hat, *, l, steady, s_warm, gam, dlt, dsub, gcc, g,
                   invd=None, stencil_hw=None):
    """Plain version of the fused p(l)-CG body (``fused_body``).

    With ``stencil_hw`` the 5-point Dirichlet stencil is applied to
    ``Zw[:, 0]`` in place of a streamed ``t_hat`` (the SPMV stream is
    rounded to the storage dtype); ``invd`` (scalar or ``(n,)``) applies
    the diagonal preconditioner ``t = invd * t_hat``, rounded to storage.
    The v-recurrence runs only when ``steady``; the z (and, with ``Zhw``,
    zhat) recurrences take their warmup form ``t - s_warm z_0`` otherwise.
    Payload dots read the updated windows as stored, against ``zhat_new``
    when ``Zhw`` is given and ``z_new`` otherwise.  Returns
    ``(Vw2, Zw2, Zhw2 | None, dots)`` with
    ``dots = [vd_0..vd_l, zd_0..zd_{l-1}]``.
    """
    fused_body_diag(Vw.shape[0], l, Vw, Zhw, t, t_hat, invd, stencil_hw)
    acc = acc_dtype(Vw.dtype)
    V = Vw.to(acc)
    Z = Zw.to(acc)
    if stencil_hw is not None:
        H, W2d = stencil_hw
        x = Z[:, 0].reshape(H, W2d)
        zr = torch.zeros_like
        t_hat = stencil2d_ref(x, zr(x[0]), zr(x[0]), zr(x[:, 0]),
                              zr(x[:, 0])).reshape(-1).to(Zw.dtype).to(acc)
        t = t_hat
    if invd is not None:
        iv = torch.as_tensor(invd, device=Vw.device).to(acc)
        t = (iv * t_hat.to(acc)).to(Zw.dtype).to(acc)
    t = t.to(acc)[:, None]
    steady = torch.as_tensor(steady, device=Vw.device)
    g = torch.as_tensor(g, device=Vw.device).to(acc)
    vnew = (Z[:, l - 1:l] - (V[:, :2 * l] * g[None, :]).sum(dim=1, keepdim=True)) / gcc
    V2 = torch.where(steady, torch.cat([vnew, V[:, :-1]], dim=1), V)
    znew = torch.where(steady, (t - gam * Z[:, :1] - dsub * Z[:, 1:2]) / dlt,
                       t - s_warm * Z[:, :1])
    Z2 = torch.cat([znew, Z[:, :-1]], dim=1)
    lhs = znew
    Zh2 = None
    if Zhw is not None:
        Zh = Zhw.to(acc)
        th = t_hat.to(acc)[:, None]
        zhnew = torch.where(steady, (th - gam * Zh[:, :1] - dsub * Zh[:, 1:2]) / dlt,
                            th - s_warm * Zh[:, :1])
        Zh2 = torch.cat([zhnew, Zh[:, :-1]], dim=1).to(Zhw.dtype)
        lhs = zhnew
    vd = (V2.to(Vw.dtype).to(acc)[:, :l + 1] * lhs).sum(dim=0)
    zd = (Z2.to(Zw.dtype).to(acc)[:, :l] * lhs).sum(dim=0)
    return V2.to(Vw.dtype), Z2.to(Zw.dtype), Zh2, torch.cat([vd, zd])
