"""Outcome of a preconditioned p(l)-CG solve of the 2-D Poisson problem
under seeded relative perturbations of its right-hand side, on either
package: the JAX reference (``--package jax``, CPU at x64) or the PyTorch
port (``--package torch``, on ``--device``).

    python tests/prec_branches.py --package jax --nx 1000 --backend ref
    python tests/prec_branches.py --package torch --nx 1000 --backend fused \\
        --eps 2e-16 --seeds 1 2 3
    python tests/prec_branches.py --package torch --nx 32 --blocks 2 --l 2 \\
        --tol 1e-6 --device cpu --eps 1e-12 --seeds 1 2 3 4

The right-hand side is ``b = A 1``, multiplied entry by entry by
``1 + eps * N(0, 1)`` drawn from ``numpy.random.default_rng(seed)`` (seed 0
or eps 0: b unperturbed).  The preconditioner is ``BlockJacobi((nx, nx),
blocks=(k, k))``; the shifts come from its ``precond_spectrum``, as in
``solve``.  Prints one JSON line per run: updates, breakdowns, restarts and
the true relative residual from a numpy 5-point stencil.  Each package is
imported only when asked for, so ``--package torch`` runs where JAX is not
installed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np


def _stencil(u, nx):
    g = u.reshape(nx, nx)
    out = 4.0 * g
    out[1:, :] -= g[:-1, :]
    out[:-1, :] -= g[1:, :]
    out[:, 1:] -= g[:, :-1]
    out[:, :-1] -= g[:, 1:]
    return out.reshape(-1)


def _rhs(nx, eps, seed):
    b = _stencil(np.ones(nx * nx), nx)
    if eps and seed:
        b = b * (1.0 + eps * np.random.default_rng(seed).standard_normal(b.size))
    return b


def _solver(args):
    """``run(b) -> (result, x as numpy)`` on the chosen package."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    nx, blocks = args.nx, (args.blocks, args.blocks)
    kw = dict(method="plcg_scan", l=args.l, tol=args.tol, maxiter=args.maxiter,
              backend=None if args.backend == "None" else args.backend)
    if args.package == "jax":
        import jax
        jax.config.update("jax_enable_x64", True)
        from repro.core import BlockJacobi, solve
        from repro.operators import poisson2d
        A, M = poisson2d(nx), BlockJacobi((nx, nx), blocks=blocks)
        return lambda b: (lambda r: (r, np.asarray(r.x)))(solve(A, b, M=M, **kw))
    import torch
    from repro_torch.core import BlockJacobi, solve
    from repro_torch.operators import poisson2d
    A, M = poisson2d(nx), BlockJacobi((nx, nx), blocks=blocks)
    return lambda b: (lambda r: (r, r.x.cpu().numpy()))(
        solve(A, torch.from_numpy(b), M=M, device=args.device, **kw))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["jax", "torch"], required=True)
    ap.add_argument("--nx", type=int, default=1000)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--l", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=2000)
    ap.add_argument("--backend", default="None")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--eps", type=float, default=0.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    run = _solver(args)
    for seed in args.seeds:
        b = _rhs(args.nx, args.eps, seed)
        t0 = time.perf_counter()
        r, x = run(b)
        true_rel = float(np.linalg.norm(b - _stencil(x, args.nx)) / np.linalg.norm(b))
        print(json.dumps({"package": args.package, "device": "cpu" if args.package == "jax"
                          else args.device, "nx": args.nx, "blocks": args.blocks, "l": args.l,
                          "tol": args.tol, "backend": args.backend, "eps": args.eps,
                          "seed": seed, "iters": r.iters, "converged": bool(r.converged),
                          "breakdowns": r.breakdowns, "restarts": r.restarts,
                          "true_rel_residual": true_rel,
                          "sigma": [float(s) for s in r.info["sigma"]],
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
