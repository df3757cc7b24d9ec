"""Preconditioning as a first-class layer (port of ``repro.core.precond``;
paper Sec. 6, Alg. 4).

:class:`Preconditioner` carries the structural hints the engine reads:

  * ``apply(v)``        -- the full-vector ``M^{-1} v`` on ``v``'s device;
  * ``inv_diag``        -- optional diagonal hint: when set, ``M^{-1}`` IS
    an elementwise multiply, so ``backend="fused"`` folds the apply (and
    the zhat window recurrence) into its one ``fused_body`` launch per
    body instead of splitting the body into ``stencil2d`` + ``fused_body``;
  * ``precond_spectrum(base)`` -- optional inclusion interval for the
    spectrum of ``M^{-1} A``, used to default the auxiliary-basis shifts
    of the preconditioned pipeline;
  * ``residual_gap`` (module function): the attainable-accuracy gap
    between the true and the recursive residual of a finished solve.

Concrete implementations: :class:`Identity`, :class:`Jacobi` (scalar or
``(n,)`` inverse diagonal), :class:`BlockJacobi` (block-local Chebyshev
approximate inverse of the Poisson stencil) and :class:`Chebyshev`
(polynomial in the full operator).  The block stencil and the Chebyshev
polynomial are plain torch, as they are plain jnp in the reference.

The mesh forms (``local_apply``, ``BlockJacobi.for_mesh``, a
``Chebyshev`` built from a distributed operator) wait for the mesh port
and raise ``NotImplementedError`` naming ROADMAP A.9.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .shifts import chebyshev_shifts


def _mesh_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} belongs to the mesh execution path, which is not "
                               "ported to repro_torch yet (ROADMAP A.9)")


# --------------------------------------------------------------------------
# shared polynomial machinery (reuses the shift roots of core.shifts)
# --------------------------------------------------------------------------

def chebyshev_inverse_apply(matvec: Callable, v: torch.Tensor,
                            shifts: Sequence[float]) -> torch.Tensor:
    """``p(A) v`` with ``p(t) = (1 - prod_i (1 - t/sigma_i)) / t``.

    The ``sigma_i`` are the degree-m Chebyshev roots on ``[lmin, lmax]``,
    so ``1 - t p(t)`` is the scaled Chebyshev residual polynomial and
    ``p(A)`` is SPD whenever ``spec(A)`` lies in ``(0, lmax]``.  Uses
    ``len(shifts) - 1`` operator applications.
    """
    # factored update: x_{k+1} = x_k + r_k / s_{k+1}, r_{k+1} = (I - A/s) r_k
    x = v * 0
    r = v
    for j, s in enumerate(shifts):
        x = x + r / s
        if j + 1 < len(shifts):            # last residual is never read
            r = r - matvec(r) / s
    return x


def _cheb_tp_range(lmin: float, lmax: float, degree: int, tmax: float) -> tuple:
    """Numerical range of ``t * p(t)`` over ``(0, tmax]`` for the
    degree-``degree`` Chebyshev inverse polynomial on ``[lmin, lmax]``."""
    sig = np.asarray(chebyshev_shifts(lmin, lmax, degree))
    t = np.linspace(tmax / 4096.0, tmax, 4096)
    r = np.ones_like(t)
    for s in sig:
        r *= 1.0 - t / s
    tp = 1.0 - r
    return float(tp.min()), float(tp.max())


# --------------------------------------------------------------------------
# the protocol
# --------------------------------------------------------------------------

class Preconditioner:
    """Base class / structural protocol for SPD preconditioners.

    Only the inverse application ``M^{-1} v`` is ever required.
    Subclasses override :meth:`apply`; everything else has safe defaults.
    """

    name: str = "M"

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.apply(v)

    @property
    def is_identity(self) -> bool:
        """True when ``apply`` is the identity: the engine then runs the
        unpreconditioned pipeline (3l+2 instead of 3l+5 vectors)."""
        return False

    @property
    def inv_diag(self):
        """Inverse diagonal (a float or an ``(n,)`` numpy array) when
        ``M^{-1}`` is an elementwise multiply, else None."""
        return None

    def local_apply(self, op):
        raise _mesh_not_ported("Preconditioner.local_apply")

    def precond_spectrum(self, base: tuple = (0.0, 8.0), device=None) -> Optional[tuple]:
        """Inclusion interval for ``spec(M^{-1} A)`` given ``base`` for
        ``spec(A)``, or None when unknown.  An estimate that does vector
        work (BlockJacobi's power iteration) runs on ``device`` (None: the
        CPU); the interval does not depend on it."""
        return None

    def runtime(self) -> Optional["Preconditioner"]:
        """Self, or None for the identity."""
        return None if self.is_identity else self


class Identity(Preconditioner):
    """The trivial preconditioner: ``M=Identity()`` is the unpreconditioned
    solve."""

    name = "I"

    def apply(self, v):
        return v

    @property
    def is_identity(self):
        return True

    @property
    def inv_diag(self):
        return 1.0

    def precond_spectrum(self, base=(0.0, 8.0), device=None):
        return tuple(base)


def _as_numpy(d) -> np.ndarray:
    if isinstance(d, torch.Tensor):
        d = d.detach().cpu().numpy()
    return np.asarray(d, dtype=float)


class Jacobi(Preconditioner):
    """Diagonal preconditioner ``M = diag(d)``; ``apply`` multiplies by
    ``1/d``.  A constant diagonal collapses to a scalar inverse.  Carries
    the ``inv_diag`` hint, so ``backend="fused"`` keeps ONE launch per
    body."""

    def __init__(self, diag, name: str = "jacobi"):
        self.name = name
        d = _as_numpy(diag)
        if d.ndim == 0 or (d.size and np.all(d == d.reshape(-1)[0])):
            self._inv = float(1.0 / (d if d.ndim == 0 else d.reshape(-1)[0]))
            self._scalar = True
        else:
            self._inv = 1.0 / d
            self._scalar = False
        self._inv_on: dict = {}              # device -> the (n,) inverse as a tensor

    @classmethod
    def from_operator(cls, A) -> "Jacobi":
        if getattr(A, "diag", None) is None:
            raise ValueError("operator exposes no diagonal")
        return cls(A.diag, name=f"jacobi({getattr(A, 'name', 'A')})")

    def apply(self, v):
        if self._scalar:
            return v * self._inv
        inv = self._inv_on.get(v.device)
        if inv is None:
            # float64, as the reference multiplies by its float64 numpy array
            inv = self._inv_on[v.device] = torch.as_tensor(self._inv, device=v.device)
        return v * inv

    @property
    def inv_diag(self):
        return self._inv

    def precond_spectrum(self, base=(0.0, 8.0), device=None):
        lo, hi = base
        if self._scalar:
            return (lo * self._inv, hi * self._inv)
        imin, imax = float(np.min(self._inv)), float(np.max(self._inv))
        return (lo * imin, hi * imax)


def _block_stencil5(g: torch.Tensor) -> torch.Tensor:
    """Zero-Dirichlet 5-point stencil on each trailing 2-D block of ``g``
    (no halos): the block-diagonal part of the Poisson operator."""
    out = 4.0 * g
    out[..., 1:, :] -= g[..., :-1, :]
    out[..., :-1, :] -= g[..., 1:, :]
    out[..., :, 1:] -= g[..., :, :-1]
    out[..., :, :-1] -= g[..., :, 1:]
    return out


class BlockJacobi(Preconditioner):
    """Block-Jacobi for the 2-D Poisson stencil: each ``(nx/px, ny/py)``
    block is approximately inverted by a degree-``degree`` Chebyshev
    polynomial of the block-local zero-Dirichlet stencil (SPD by
    construction).  ``apply`` treats all blocks at once as one
    ``(px*py, bx, by)`` batch."""

    def __init__(self, stencil2d: tuple, blocks: tuple = (1, 1), degree: int = 4,
                 spectrum: tuple = (0.5, 8.0), power_iters: int = 32,
                 name: Optional[str] = None):
        nx, ny = stencil2d
        px, py = blocks
        if nx % px or ny % py:
            raise ValueError(f"grid {stencil2d} must divide blocks {blocks}")
        if not 0 < spectrum[0] < spectrum[1]:
            raise ValueError(f"need 0 < lmin < lmax, got {spectrum}")
        self.stencil2d = (int(nx), int(ny))
        self.blocks = (int(px), int(py))
        self.degree = int(degree)
        self.spectrum = (float(spectrum[0]), float(spectrum[1]))
        self.power_iters = int(power_iters)
        self._shifts = tuple(chebyshev_shifts(*self.spectrum, degree))
        self._pspec: Optional[tuple] = None     # lazy precond_spectrum
        self.name = name or f"block-jacobi{self.blocks}-cheb{degree}"

    @classmethod
    def for_mesh(cls, A, mesh, **kw) -> "BlockJacobi":
        raise _mesh_not_ported("BlockJacobi.for_mesh")

    def apply(self, v):
        nx, ny = self.stencil2d
        px, py = self.blocks
        bx, by = nx // px, ny // py
        g = (v.reshape(nx, ny).reshape(px, bx, py, by).permute(0, 2, 1, 3)
             .reshape(px * py, bx, by))
        out = chebyshev_inverse_apply(_block_stencil5, g, self._shifts)
        out = out.reshape(px, py, bx, by).permute(0, 2, 1, 3).reshape(nx, ny)
        return out.reshape(v.shape)

    def precond_spectrum(self, base=(0.0, 8.0), device=None):
        # a tight interval matters: a slack upper bound misplaces the
        # auxiliary-basis shifts (paper Sec. 4).  Estimate lam_max(M^{-1} A)
        # by power iteration from the reference's start vector, in float64
        # (the shifts, hence the iteration counts, depend on it);
        # power_iters=0 falls back to the analytic split bound.
        if self._pspec is not None:
            return self._pspec
        lo, hi = self.spectrum
        if self.power_iters > 0:
            nx, ny = self.stencil2d
            v = torch.from_numpy(np.random.default_rng(7).standard_normal(nx * ny))
            v = v.to("cpu" if device is None else device)
            lam = hi
            for _ in range(self.power_iters):
                w = self.apply(_block_stencil5(v.reshape(nx, ny)).reshape(-1))
                lam = float(torch.dot(v, w) / torch.dot(v, v))
                v = w / torch.linalg.norm(w)
            self._pspec = (0.0, 1.05 * lam)
            return self._pspec
        tmax = float(base[1])
        tp_max = _cheb_tp_range(lo, hi, self.degree, tmax)[1]
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        s = theta / delta
        m = self.degree
        tm = math.cosh(m * math.acosh(s))
        tmp = m * math.sinh(m * math.acosh(s)) / math.sinh(math.acosh(s))
        p0 = tmp / (delta * tm)
        self._pspec = (0.0, tp_max + 2.0 * p0)
        return self._pspec


class Chebyshev(Preconditioner):
    """Polynomial preconditioner ``M^{-1} = p(A)`` with ``p`` the
    degree-``degree`` Chebyshev approximation of ``1/t`` on ``spectrum``,
    from the same roots as the auxiliary-basis shifts."""

    def __init__(self, A=None, *, spectrum: tuple = (0.5, 8.0), degree: int = 3,
                 matvec: Optional[Callable] = None, name: Optional[str] = None):
        if matvec is None:
            if A is None:
                raise ValueError("Chebyshev needs A (operator) or matvec=")
            if hasattr(A, "matvec"):
                matvec = A.matvec
            elif callable(A):
                matvec = A
            elif hasattr(A, "matvec_local"):
                raise _mesh_not_ported("Chebyshev of a distributed operator")
            else:
                raise TypeError(f"cannot take a matvec from {type(A).__name__}")
        if not 0 < spectrum[0] < spectrum[1]:
            raise ValueError(f"need 0 < lmin < lmax, got {spectrum}")
        self._matvec = matvec
        self.degree = int(degree)
        self.spectrum = (float(spectrum[0]), float(spectrum[1]))
        self._shifts = tuple(chebyshev_shifts(*self.spectrum, degree))
        self.name = name or f"chebyshev-{degree}"

    def apply(self, v):
        return chebyshev_inverse_apply(self._matvec, v, self._shifts)

    def precond_spectrum(self, base=(0.0, 8.0), device=None):
        lo, hi = self.spectrum
        _, tpmax = _cheb_tp_range(lo, hi, self.degree, float(base[1]))
        return (0.0, tpmax)


class _CallablePreconditioner(Preconditioner):
    """Promotion of a bare ``M=`` callable (incl. the legacy
    ``linop.Preconditioner`` dataclass): full-vector apply only."""

    def __init__(self, fn: Callable, name: str = "M"):
        self._fn = fn
        self.name = name

    def apply(self, v):
        return self._fn(v)


def as_preconditioner(M) -> Preconditioner:
    """Coerce ``M`` (None | Preconditioner | callable) to the protocol;
    ``None`` becomes :class:`Identity`."""
    if M is None:
        return _IDENTITY
    if isinstance(M, Preconditioner):
        return M
    if callable(M):
        return _CallablePreconditioner(M, name=getattr(M, "name", "M"))
    raise TypeError(f"cannot interpret {type(M).__name__} as a preconditioner "
                    "(need a callable applying M^{-1} v)")


_IDENTITY = Identity()


# --------------------------------------------------------------------------
# attainable-accuracy diagnostics (paper Sec. 4 / arXiv:1804.02962)
# --------------------------------------------------------------------------

def residual_gap(A, b, result, lane: Optional[int] = None) -> dict:
    """Residual-gap report for a finished solve: the true residual
    ``||b - A x||``, the implicit ``|zeta_k|`` the stopping test saw, their
    gap and the gap relative to ``||b||``.  For a batched result pass
    ``lane`` (and that lane's ``b``)."""
    x = torch.as_tensor(result.x)
    bb = torch.as_tensor(b, device=x.device)
    traces = result.resnorms
    if x.numel() != bb.numel():
        if lane is None:
            raise ValueError("batched result: pass lane= (and that lane's b) to residual_gap")
        x = x[lane]
        traces = traces[lane]
    elif lane is not None:
        traces = traces[lane]
    true = float(torch.linalg.norm((bb.reshape(-1) - (A @ x.reshape(-1))).reshape(-1)))
    last = traces[-1] if len(traces) else 0.0
    while isinstance(last, (list, tuple, np.ndarray)):
        last = last[-1] if len(last) else 0.0
    implicit = float(last)
    bnorm = float(torch.linalg.norm(bb.reshape(-1))) or 1.0
    return {"true_resnorm": true, "implicit_resnorm": implicit,
            "gap": abs(true - implicit), "rel_gap": abs(true - implicit) / bnorm}
