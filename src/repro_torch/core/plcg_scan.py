"""Production p(l)-CG engine in PyTorch (port of ``repro.core.plcg_scan``).

The realization of paper Alg. 2 + Alg. 3 on torch tensors:

* vectors live in fixed-size **sliding windows** stored **lane-major**,
  exactly as in the JAX engine: ``Zw (n, l+1)`` holds the last l+1
  auxiliary vectors, ``Vw (n, 2l+1)`` the last 2l+1 basis vectors, slot 0
  newest;
* G is stored **banded by column** (Lemma 5): row c of ``Gb`` holds the
  2l+1-entry band of G's column c;
* the 2l+1 dot products of body i form one payload pushed into a depth-l
  **in-flight queue** and read l bodies later (the ``MPI_Wait`` of Alg. 3).

Where the JAX engine traces one ``lax.scan``, this engine runs the bodies
from a host loop.  On the non-restart path the phase counter ``ph`` equals
the loop index, so everything it decides is decided on the host: the
column ``c = ph - l + 1`` being finalized, warmup vs steady, the banded-G
row indices, and the startup-vs-symmetric choice of V-dots.  A warmup body
therefore skips the steady branch the JAX body computes and discards (the
selected values are identical).  The convergence / breakdown flags and
every scalar recurrence stay on the device, combined with ``torch.where``
as in ``finalize``; nothing is read back per body.

A body that does not commit (the lane was done already, or it breaks
down now) leaves the lane done for good, so only what the sweep returns
-- ``x``, ``k_done`` and the flags -- is select-gated on ``commit``; the
windows and scalar state advance unconditionally and are never read
again.  The host checks ``done`` every ``CHECK_EVERY`` bodies and stops
early: the bodies it skips would change nothing, so ``resnorms`` and
``committed`` (``iters`` rows, zeros where nothing was committed) are
exactly what the full sweep returns.

``backend`` selects the implementation of the body's vector work:

  * ``None``    -- inline torch math;
  * ``"ref"``   -- the plain kernel versions of ``kernels.ref`` for the
    (K4) window AXPY and the (K5) multi-dots;
  * ``"cuda"``  -- the per-kernel tier, the counterpart of the JAX
    package's ``"pallas"`` tier: the hand-written ``window_axpy`` kernel
    once per steady body (the warmup bodies skip the discarded branch)
    and ``multidot`` for the Z-dots of every body plus the V-dots of the
    first 2l-1 bodies (later bodies take one plain dot and fill the rest
    from the symmetry of G, as the reference does);
  * ``"fused"`` -- ONE ``fused_body`` launch per body: (K4) + (K5), plus
    the (K1) SPMV when ``stencil_hw`` marks the operator as the 2-D
    Poisson stencil; otherwise the operator's ``t = A z`` streams in;
  * ``"auto"``  -- ``"cuda"`` for tensors on a CUDA device, ``"ref"`` on
    the CPU.

The kernel wrappers take the plain versions for tensors on the CPU, so
every tier runs on the CPU as well.  ``backend="pallas"`` is rejected with
a pointer to ``"cuda"``.  On a CUDA device the engine sets
``torch.backends.cuda.matmul.allow_tf32 = False``: the float32 ``@`` of
the inline tier and of dense operators runs in full float32.

Not ported yet, each raising ``NotImplementedError`` where it is asked
for: preconditioning (ROADMAP A.6), non-default precision policies (A.7),
the in-scan restart / residual replacement machinery (A.8), injected dots
and ``comm=`` (A.9).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from .precision import as_precision_policy

BACKENDS = (None, "ref", "cuda", "fused")

#: bodies between two host reads of the device ``done`` flag
CHECK_EVERY = 64


def resolve_backend(backend, device: torch.device):
    """Validate ``backend`` and resolve ``"auto"`` for ``device``."""
    if backend == "pallas":
        raise ValueError(
            "backend='pallas' names the JAX package's per-kernel Pallas tier; its "
            "counterpart in repro_torch is backend='cuda'")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "ref"
    if backend not in BACKENDS:
        raise ValueError("backend must be None, 'auto', 'cuda', 'ref' or 'fused', "
                         f"got {backend!r}")
    return backend


@dataclasses.dataclass
class PLCGState:
    """Sweep state, laid out as the JAX engine's ``PLCGState``.  The zhat
    window and the restart micro-state wait for ROADMAP A.6 / A.8."""

    Zw: torch.Tensor         # (n, l+1)  z_i .. z_{i-l}        (slot 0 newest)
    Vw: torch.Tensor         # (n, 2l+1) v_{i-l} .. v_{i-3l}   (slot 0 newest)
    Gb: torch.Tensor         # (ncols, 2l+1) banded G, row c = band of column c
    gam: torch.Tensor        # (ncols,)
    dlt: torch.Tensor        # (ncols,)
    inflight: collections.deque  # the l payloads in flight, oldest first
    x: torch.Tensor          # (n,) current solution x_{i-l}
    p: torch.Tensor          # (n,) search direction p_{i-l}
    eta: torch.Tensor        # scalar eta_{i-l}
    zeta: torch.Tensor       # scalar zeta_{i-l}
    k_done: torch.Tensor     # committed solution updates minus one
    done: torch.Tensor       # bool: converged, broken down or out of budget
    converged: torch.Tensor  # bool
    breakdown: torch.Tensor  # bool


class PLCGOut(NamedTuple):
    x: torch.Tensor
    resnorms: torch.Tensor   # (iters,) |zeta_k| per body (0 where not committed)
    k_done: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor
    committed: torch.Tensor  # (iters,) bool: body committed a solution update
    bodies: int              # bodies run before the early stop (<= iters)


def plcg_scan(
    matvec: Callable,
    b,
    x0=None,
    *,
    l: int,
    iters: int,
    sigma: Sequence[float],
    tol: float = 0.0,
    exploit_symmetry: bool = True,
    backend: Optional[str] = None,
    stencil_hw: Optional[tuple] = None,
    k_budget: Optional[int] = None,
    precision=None,
    device="cuda",
) -> PLCGOut:
    """Run up to ``iters`` bodies of p(l)-CG (solution index reaches
    iters-l-1); see the module docstring for the tiers and the freeze.

    ``b`` and ``x0`` are moved to ``device`` (default the CUDA card).
    ``k_budget`` (a host int >= 1) freezes the sweep -- without setting
    ``converged`` or ``breakdown`` -- once that many solution updates have
    been committed.
    """
    if l < 1:
        raise ValueError("l must be >= 1")
    if k_budget is not None and int(k_budget) < 1:
        raise ValueError(f"k_budget must be >= 1, got {k_budget}")
    if not as_precision_policy(precision).is_default:
        raise NotImplementedError(
            "precision policies other than the default are not ported yet "
            "(ROADMAP A.7)")
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    b = torch.as_tensor(b, device=dev)
    if b.dim() != 1 or not b.is_floating_point():
        raise ValueError(f"b must be a 1-D floating tensor, got {tuple(b.shape)} {b.dtype}")
    cdt = b.dtype
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=dev).to(cdt)
    use_fused = backend == "fused"
    use_kernels = backend in ("cuda", "ref")
    fuse_stencil = use_fused and stencil_hw is not None
    n = b.shape[0]
    if fuse_stencil and stencil_hw[0] * stencil_hw[1] != n:
        raise ValueError(f"stencil_hw {stencil_hw} inconsistent with n={n}")
    if backend == "ref":
        mdot, waxpy = kref.multidot_ref, kref.window_axpy_ref
    else:
        mdot, waxpy = kops.multidot_apply, kops.window_axpy_apply
    W = 2 * l + 1
    ncols = iters + 2 * l + 2
    sig = torch.tensor([float(s) for s in sigma], dtype=cdt, device=dev)
    if sig.shape != (l,):
        raise ValueError(f"need exactly l={l} shifts, got {sig.shape[0]}")
    tiny = torch.finfo(cdt).tiny
    zero = torch.zeros((), dtype=cdt, device=dev)
    zeros_l = torch.zeros(l, dtype=cdt, device=dev)

    # ---- initialization (Alg. 2 lines 1-3) -------------------------------
    rhat0 = b - matvec(x).to(cdt)
    init_pay = torch.stack([torch.dot(rhat0, rhat0), torch.dot(b, b)])
    beta0 = torch.sqrt(init_pay[0])
    bnorm = torch.sqrt(init_pay[1])
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    tol_b = tol * bnorm
    v0 = rhat0 / beta0
    Zw = torch.zeros((n, l + 1), dtype=cdt, device=dev)
    Zw[:, 0] = v0
    Vw = torch.zeros((n, W), dtype=cdt, device=dev)
    Vw[:, 0] = v0
    Gb = torch.zeros((ncols, W), dtype=cdt, device=dev)
    Gb[0, 2 * l] = 1.0
    false = torch.zeros((), dtype=torch.bool, device=dev)
    st = PLCGState(
        Zw=Zw, Vw=Vw, Gb=Gb,
        gam=torch.zeros(ncols, dtype=cdt, device=dev),
        dlt=torch.zeros(ncols, dtype=cdt, device=dev),
        inflight=collections.deque(torch.zeros(W, dtype=cdt, device=dev) for _ in range(l)),
        x=x, p=torch.zeros_like(x), eta=zero.clone(), zeta=zero.clone(),
        k_done=torch.full((), -1, dtype=torch.int64, device=dev),
        done=false.clone(), converged=false.clone(), breakdown=false.clone())
    resnorms = torch.zeros(iters, dtype=cdt, device=dev)
    committed = torch.zeros(iters, dtype=torch.bool, device=dev)
    spare = (torch.empty_like(Vw), torch.empty_like(Zw)) if use_fused else None

    def scalar_block(ph, c, col_in):
        """(K2)+(K3): finalize column c of G from the arrived payload and
        update the gamma/delta recurrences (steady bodies only).  Writes
        row c of ``Gb`` and entry c-1 of ``gam``/``dlt`` in place."""
        col = col_in.clone()
        # symmetric fill (eq. 14): rows c-2l+k, k<l, from earlier columns;
        # G[c-l+k, 2l-k] is the anti-diagonal read below (all rows exist
        # once ph >= 3l-1)
        if exploit_symmetry and ph >= 3 * l - 1:
            col[:l] = st.Gb.as_strided((l,), (W - 1,), (c - l) * W + 2 * l)
        # (K2) Gram-Schmidt correction (lines 7-8)
        for k in range(l + 1, 2 * l):
            r = c - 2 * l + k
            if r >= 0:
                grow = st.Gb[r]
                s = torch.dot(grow[2 * l - k:2 * l], col[:k])
                col[k] = (col[k] - s) / grow[2 * l]
        arg = col[2 * l] - torch.dot(col[:2 * l], col[:2 * l])
        brk = (arg <= 0.0) | ~torch.isfinite(arg)
        gcc = torch.sqrt(torch.clamp(arg, min=tiny))
        col[2 * l] = gcc
        st.Gb[c] = col
        # (K3) gamma_{c-1}, delta_{c-1} (lines 10-16)
        rowm1 = st.Gb[c - 1]
        gd = rowm1[2 * l]
        g_cm1_c = col[2 * l - 1]
        sub = rowm1[2 * l - 1] * st.dlt[c - 2] if c >= 2 else zero
        if ph < 2 * l:
            sig_c = sig[min(max(c - 1, 0), l - 1)]
            gam_c1 = (g_cm1_c + sig_c * gd - sub) / gd
            dlt_c1 = gcc / gd
        else:
            idx = max(c - 1 - l, 0)
            gam_c1 = (gd * st.gam[idx] + g_cm1_c * st.dlt[idx] - sub) / gd
            dlt_c1 = gcc * st.dlt[idx] / gd
        dsub = st.dlt[c - 2].clone() if c >= 2 else zero
        st.gam[c - 1] = gam_c1
        st.dlt[c - 1] = dlt_c1
        return col, gcc, brk, gam_c1, dlt_c1, dsub

    def solution_update(ph, v_k):
        """(K6) solution update (lines 22-31), steady bodies only."""
        k = ph - l
        if ph == l:
            eta_k = st.gam[0].clone()
            zeta_k = beta0
            x2 = st.x
            p2 = v_k / torch.where(eta_k == 0, 1.0, eta_k)
        else:
            dkm1 = st.dlt[k - 1]
            lam = dkm1 / torch.where(st.eta == 0, 1.0, st.eta)
            eta_k = st.gam[k] - lam * dkm1
            zeta_k = -lam * st.zeta
            x2 = st.x + st.zeta * st.p
            p2 = (v_k - dkm1 * st.p) / torch.where(eta_k == 0, 1.0, eta_k)
        return x2, p2, eta_k, zeta_k, st.k_done + 1

    def payload_of(ph, vd, zd):
        """Band-layout payload ``[vd reversed, zd reversed]``; the V-dot
        slots whose row ``i+1-2l+k`` is negative are masked to zero (the
        V window is zero-initialized except v_0, which must not leak into
        nonexistent rows during warmup)."""
        mask_from = 2 * l - 1 - ph            # first unmasked slot of vd[::-1]
        vrev = vd.flip(0)
        if mask_from > 0:
            keep = (torch.arange(l + 1, device=dev) >= mask_from).to(cdt)
            vrev = vrev * keep
        return torch.cat([vrev, zd.flip(0)])

    def finalize(i, ph, payload, brk, x2, p2, eta2, zeta2, k2, Vw2, Zw2):
        """Queue push + convergence / freeze commit (see module docstring)."""
        st.inflight.append(payload)
        steady = ph >= l
        active = ~st.done
        if steady:
            brk2 = brk | ~torch.isfinite(zeta2)
            commit = active & ~brk2
            conv_now = commit & (zeta2.abs() <= tol_b)
            brk_term = brk2 & active
            st.x = torch.where(commit, x2, st.x)
            st.k_done = torch.where(commit, k2, st.k_done)
            resnorms[i] = torch.where(commit, zeta2.abs(), zero)
            committed[i] = commit
            # an active lane has committed exactly ph - l updates before
            # this body, so the budget test is a host comparison
            spent = k_budget is not None and ph - l + 1 >= k_budget
            st.done = st.done | brk_term | conv_now | (active if spent else false)
            st.converged = st.converged | conv_now
            st.breakdown = st.breakdown | brk_term
        st.p, st.eta, st.zeta, st.Vw, st.Zw = p2, eta2, zeta2, Vw2, Zw2

    def body(i):
        ph = i
        t = matvec(st.Zw[:, 0]).to(cdt)               # (K1) SPMV
        col_in = st.inflight.popleft()
        steady = ph >= l
        if steady:
            col, gcc, brk, gam_c1, dlt_c1, dsub = scalar_block(ph, ph - l + 1, col_in)
            g = col[:2 * l].flip(0)
            # (K4) v recurrence (line 17): v_c = (z_c - sum_k g_k v_{c-2l+k}) / gcc
            if use_kernels:
                vnew = waxpy(st.Vw[:, :2 * l], st.Zw[:, l - 1], g, gcc).to(cdt)
            else:
                vnew = (st.Zw[:, l - 1] - st.Vw[:, :2 * l] @ g) / gcc
            Vw2 = torch.cat([vnew[:, None], st.Vw[:, :-1]], dim=1)
            # (K4) z recurrence (line 18)
            znew = (t - gam_c1 * st.Zw[:, 0] - dsub * st.Zw[:, 1]) / dlt_c1
            x2, p2, eta2, zeta2, k2 = solution_update(ph, Vw2[:, 1])
        else:
            znew = t - sig[min(ph, l - 1)] * st.Zw[:, 0]
            Vw2, brk = st.Vw, None
            x2, p2, eta2, zeta2, k2 = st.x, st.p, st.eta, st.zeta, st.k_done
        Zw2 = torch.cat([znew[:, None], st.Zw[:, :-1]], dim=1)
        # (K5) dot-product payload for column i+1
        if exploit_symmetry and ph >= 2 * l - 1:
            vd = torch.cat([torch.dot(Vw2[:, 0], znew).reshape(1), zeros_l])
        elif use_kernels:
            vd = mdot(Vw2[:, :l + 1], znew).to(cdt)
        elif exploit_symmetry:
            vd = znew @ Vw2[:, :l + 1]
        else:
            vd = torch.stack([torch.dot(Vw2[:, j], znew) for j in range(l + 1)])
        if use_kernels:
            zd = mdot(Zw2[:, :l], znew).to(cdt)
        else:
            zd = torch.stack([torch.dot(Zw2[:, j], znew) for j in range(l)])
        finalize(i, ph, payload_of(ph, vd, zd), brk, x2, p2, eta2, zeta2, k2, Vw2, Zw2)

    def body_fused(i):
        """One ``fused_body`` launch: (K1 when the stencil is fused) + (K4)
        + (K5); only the O(l^2) scalar recurrences stay in torch."""
        nonlocal spare
        ph = i
        col_in = st.inflight.popleft()
        steady = ph >= l
        if steady:
            col, gcc, brk, gam_c1, dlt_c1, dsub = scalar_block(ph, ph - l + 1, col_in)
            g = col[:2 * l].flip(0)
        else:  # the kernel ignores the steady-only scalars in a warmup body
            gcc, brk, gam_c1, dlt_c1, dsub = 1.0, None, 0.0, 1.0, 0.0
            g = torch.zeros(2 * l, dtype=cdt, device=dev)
        t = None if fuse_stencil else matvec(st.Zw[:, 0]).to(cdt).contiguous()
        Vw2, Zw2, dots = kops.fused_body_apply(
            st.Vw, st.Zw, t, l=l, steady=steady, s_warm=sig[min(ph, l - 1)],
            gam=gam_c1, dlt=dlt_c1, dsub=dsub, gcc=gcc, g=g,
            stencil_hw=stencil_hw if fuse_stencil else None, out=spare)
        spare = (st.Vw, st.Zw)
        dots = dots.to(cdt)
        if steady:
            x2, p2, eta2, zeta2, k2 = solution_update(ph, Vw2[:, 1])
        else:
            x2, p2, eta2, zeta2, k2 = st.x, st.p, st.eta, st.zeta, st.k_done
        if exploit_symmetry and ph >= 2 * l - 1:
            # beyond the startup phase only <v_{i+1-2l}, z> is new; the
            # rest comes from the symmetric fill of (K2)
            vd = torch.cat([dots[:1], zeros_l])
        else:
            vd = dots[:l + 1]
        finalize(i, ph, payload_of(ph, vd, dots[l + 1:]), brk, x2, p2, eta2, zeta2,
                 k2, Vw2, Zw2)

    step = body_fused if use_fused else body
    bodies = 0
    for i in range(iters):
        if i and i % CHECK_EVERY == 0 and bool(st.done):
            break
        step(i)
        bodies += 1
        if k_budget is not None and i - l + 1 >= k_budget:
            break                                   # the budget froze the lane
    return PLCGOut(x=st.x, resnorms=resnorms, k_done=st.k_done,
                   converged=st.converged, breakdown=st.breakdown,
                   committed=committed, bodies=bodies)


def stab_iter_slack(l: int, restart=None, rr_period=None, maxiter: int = 0) -> int:
    """Extra scan bodies needed so a ``maxiter``-update budget stays
    spendable despite re-seed dead bodies: each restart / residual
    replacement event costs at most 2l+2 bodies that commit nothing.
    It sizes the in-scan stability path (ROADMAP A.8); on this slice's
    path both knobs are None, the slack is 0 and a sweep runs
    ``maxiter + l + 1`` bodies."""
    slack = 0
    if restart:
        slack += int(restart) * (2 * l + 2)
    if rr_period and maxiter:
        slack += (int(maxiter) // int(rr_period)) * (2 * l + 2)
    return slack


def run_restart_driver(sweep, b, x0, *, tol: float, maxiter: int, max_restarts: int,
                       bnorm: float):
    """Restart-on-breakdown with a global iteration budget (paper Remark 8):
    the host loop of the JAX driver (its ``in_scan=False`` path).  The
    sweep is re-entered from the host after each breakdown with the
    *remaining* budget; a breakdown-looping system performs at most
    ``maxiter`` updates in total, and a happy breakdown at tolerance
    (``resnorms[-1] <= 4 tol ||b||``) counts as convergence.

    ``sweep(b, x, budget)`` returns a :class:`PLCGOut`.  Returns
    ``(x, resnorms list, info dict)``.
    """
    x = x0
    resnorms: list[float] = []
    restarts = breakdowns = bodies = 0
    total_k = 0
    converged = False
    while total_k < maxiter:
        remaining = maxiter - total_k
        out = sweep(b, x, remaining)
        x = out.x
        bodies += out.bodies
        resnorms.extend(r for r in out.resnorms.cpu().tolist() if r > 0)
        total_k += max(int(out.k_done) + 1, 1)
        if bool(out.converged):
            converged = True
            break
        if bool(out.breakdown):
            breakdowns += 1
            if resnorms and resnorms[-1] <= 4 * tol * bnorm:
                converged = True          # happy breakdown at tolerance
                break
            if restarts >= max_restarts:
                break
            restarts += 1
            continue
        break                             # iteration budget exhausted
    return x, resnorms, {
        "converged": converged, "breakdowns": breakdowns,
        "restarts": restarts, "replacements": 0, "iterations": total_k,
        "bodies": bodies,
    }


def plcg_solve(matvec, b, x0=None, *, l, sigma, tol=1e-8, maxiter=1000,
               exploit_symmetry: bool = True, max_restarts: int = 5,
               backend: Optional[str] = None, stencil_hw: Optional[tuple] = None,
               precision=None, device="cuda"):
    """Driver around the engine: explicit restart on square-root breakdown
    (paper Remark 8), happy-breakdown detection, and a GLOBAL iteration
    budget across restart sweeps (each sweep gets the remaining budget).

    Returns (x, resnorms, info dict).
    """
    dev = resolve_device(device)
    b = torch.as_tensor(b, device=dev)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=dev).to(b.dtype)
    bnorm = float(torch.linalg.norm(b))
    if bnorm == 0:
        bnorm = 1.0
    iters = maxiter + l + 1

    def sweep(bb, xx, kb):
        return plcg_scan(matvec, bb, xx, l=l, iters=iters, sigma=sigma, tol=tol,
                         exploit_symmetry=exploit_symmetry, backend=backend,
                         stencil_hw=stencil_hw, k_budget=kb, precision=precision,
                         device=dev)

    return run_restart_driver(sweep, b, x0, tol=tol, maxiter=maxiter,
                              max_restarts=max_restarts, bnorm=bnorm)
