"""Solver launcher of the port: the paper's workload, a p(l)-CG solve of
the 2-D Poisson problem, through ``repro_torch.core.solve`` on one device.

  python -m repro_torch.launch.solve --backend fused           # 1000x1000, l=3
  python -m repro_torch.launch.solve --nx 64 --device cpu --backend ref
  python -m repro_torch.launch.solve --backend fused --iters 300 --tol 0 --profile

Defaults follow ``repro_torch.configs.poisson2d.CONFIG`` (the paper's
Sec. 5 test setup 1); the right-hand side is ``b = A 1`` as in
``repro.launch.solve``.  Prints one line with the outcome, the true
relative residual, the wall time per body and the kernel launch counts.

``--profile`` (CUDA only) solves once to warm up, then runs the same solve
under ``torch.profiler`` and adds one JSON line saying where a body's time
goes: wall time per body, device-busy time per body (the CUDA kernels'
self time summed), the device's idle share, CUDA kernels per body and the
kernels that take the most device time.  When the profiler records no
device time, those fields say "not measured".  The profiler stretches the
host's part of a body, so the idle share it gives is an upper bound.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from ..configs.poisson2d import CONFIG
from ..core import chebyshev_shifts, solve
from ..device import resolve_device
from ..kernels import launch_counts
from ..operators import poisson2d


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile_row(prof, wall: float, bodies: int) -> dict:
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    row = {"wall_us_per_body": 1e6 * wall / bodies}
    if busy_us <= 0:
        return {**row, "device_busy_us_per_body": "not measured",
                "device_idle_share": "not measured", "cuda_kernels_per_body": "not measured"}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {**row, "device_busy_us_per_body": busy_us / bodies,
            "device_idle_share": 1.0 - busy_us / (1e6 * wall),
            "cuda_kernels_per_body": sum(e.count for e in events) / bodies,
            "top_kernels": [{"name": e.key[:80], "us_per_body": e.self_device_time_total / bodies,
                             "per_body": e.count / bodies} for e in top]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=CONFIG.nx)
    ap.add_argument("--ny", type=int, default=0)
    ap.add_argument("--l", type=int, default=CONFIG.l)
    ap.add_argument("--iters", type=int, default=CONFIG.maxiter,
                    help="solution-update budget (maxiter)")
    ap.add_argument("--tol", type=float, default=CONFIG.tol)
    ap.add_argument("--backend", type=str, default=None,
                    help="kernel tier: fused|cuda|ref|auto (default: inline torch)")
    ap.add_argument("--dtype", type=str, default=CONFIG.dtype,
                    choices=["float32", "float64"])
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="warm up, then profile the solve and print where a body's time goes")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        raise SystemExit("--profile traces the CUDA card; it needs --device cuda")
    ny = args.ny or args.nx
    A = poisson2d(args.nx, ny)
    b = A @ torch.ones(A.n, dtype=getattr(torch, args.dtype), device=dev)
    kw = dict(method="plcg_scan", l=args.l, tol=args.tol, maxiter=args.iters,
              sigma=chebyshev_shifts(CONFIG.lmin, CONFIG.lmax, args.l),
              backend=args.backend, device=dev)
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        solve(A, b, **kw)                              # warm-up (first-use costs)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    before = launch_counts()
    _sync(dev)
    with prof:
        t0 = time.perf_counter()
        r = solve(A, b, **kw)
        _sync(dev)
        dt = time.perf_counter() - t0
    true_rel = float(torch.linalg.norm(b - A @ r.x) / torch.linalg.norm(b))
    bodies = r.info["bodies"]
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"plcg_scan (l={args.l}, backend={args.backend}, {args.dtype}) on "
          f"{args.nx}x{ny} over {where}: {r.iters} iters, converged={r.converged}, "
          f"breakdowns={r.breakdowns}, restarts={r.restarts}, "
          f"|b-Ax|/|b| = {true_rel:.3e}, {dt:.3f} s, {bodies} bodies, "
          f"{1e6 * dt / max(bodies, 1):.1f} us/body, launches={launches}")
    if args.profile:
        print(json.dumps({"backend": args.backend, "grid": [args.nx, ny], "l": args.l,
                          "bodies": bodies, "device": where,
                          **_profile_row(prof, dt, bodies)}), flush=True)
    return r


if __name__ == "__main__":
    main()
