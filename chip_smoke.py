#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

In order, printing one JSON line per finding:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the hand-written kernels from ``src/repro_torch/csrc``
   (wall time, cache hit, any register spills ptxas reports);
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes (1000x1000 grid, n = 10^6, l = 3, float64 and float32;
   ``fused_body`` with the in-kernel stencil and with a streamed t, warmup
   and steady): max abs and relative error, launch-counter delta, median
   kernel time (CUDA events, L2 flushed before each launch), the plain
   version's time, one PyTorch library call computing the same function
   where there is one (timed only, never used by the port), and the least
   time the card could take (bytes at 3.35 TB/s, or operations at the
   card's rate for the type);
4. the main path at full width -- the paper's 1000x1000 Poisson problem of
   ``repro_torch.configs.poisson2d`` (float64, l = 3, tol 1e-5, maxiter
   2000, b = A 1, Chebyshev shifts on (0, 8)) -- through ``solve()`` with
   ``backend="fused"``, ``"auto"`` (the per-kernel ``"cuda"`` tier) and
   ``None``, then through the ``repro_torch.launch.solve`` CLI: outcome,
   true relative residual from an independent numpy stencil, wall time,
   time per body and kernel launches, beside the JAX reference's result;
5. a prepared ``Solver`` (fused, same configuration) answering three
   requests b = A randn (numpy seeds 0, 1, 2).

Then the ``{"kernels": [...]}`` summary line and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero; so does a machine without CUDA, or a directory that is not
a checkout of the repository.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, NVIDIA data sheet
#: peak rates outside the tensor cores (NVIDIA H100 SXM data sheet)
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
TOL = {"float64": 1e-12, "float32": 1e-5}
#: the JAX reference's result on this problem (x64 CPU run of repro.core.solve)
EXPECTED = {"iters": 1345, "true_rel": 6.39e-5}
REPLACES = {"fused_body": "src/repro/kernels/fused_body.py:169",
            "multidot": "src/repro/kernels/multidot.py:44",
            "window_axpy": "src/repro/kernels/window_axpy.py:32"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def numpy_poisson_residual(x, nx, ny):
    """||b - A x|| / ||b|| with b = A 1, by a numpy 5-point stencil in f64."""
    import numpy as np

    def apply(u):
        g = u.reshape(nx, ny)
        out = 4.0 * g
        out[1:, :] -= g[:-1, :]
        out[:-1, :] -= g[1:, :]
        out[:, 1:] -= g[:, :-1]
        out[:, :-1] -= g[:, 1:]
        return out.reshape(-1)

    b = apply(np.ones(nx * ny))
    return float(np.linalg.norm(b - apply(np.asarray(x, np.float64))) / np.linalg.norm(b))


class Timer:
    """Median time of one call in ms, by CUDA events, with the 50 MB L2
    flushed before every launch (a 512 MB write also covers the host's
    launch overhead, so the events bracket device work only)."""

    def __init__(self, torch, reps: int = 15):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(512 * 2**20 // 4, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


def kernel_checks(torch, timer, n_side: int, l: int):
    """Phase 3: every kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import launch_counts, ops, ref

    n = n_side * n_side
    rows = []
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        word = torch.finfo(dtype).bits // 8
        gen = torch.Generator(device="cuda").manual_seed(0)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

        Vw, Zw, t, g = randn(n, 2 * l + 1), randn(n, l + 1), randn(n), randn(2 * l)
        sc = {k: torch.tensor(v, dtype=dtype, device="cuda")
              for k, v in dict(s_warm=0.7, gam=1.3, dlt=0.9, dsub=0.4, gcc=1.1).items()}
        cases = []
        for stencil in (True, False):
            for steady in (False, True):
                kw = dict(l=l, steady=steady, g=g, stencil_hw=(n_side, n_side) if stencil else None,
                          **sc)
                tt = None if stencil else t
                words = 2 * (3 * l + 2) * n + (0 if stencil else n)
                flops = n * ((5 if stencil else 0) + (4 * l + 7 if steady else 2) + 2 * (2 * l + 1))
                cases.append((f"fused_body[{'stencil' if stencil else 'streamed_t'},"
                              f"{'steady' if steady else 'warmup'}]", "fused_body",
                              (lambda kw=kw, tt=tt: ops.fused_body_apply(Vw, Zw, tt, **kw)),
                              (lambda kw=kw, tt=tt: ref.fused_body_ref(Vw, Zw, tt, **kw)),
                              None, words, flops))
        for label, W_, m in (("V-dots", Vw[:, :l + 1], l + 1), ("Z-dots", Zw[:, :l], l)):
            cases.append((f"multidot[{label},m={m}]", "multidot",
                          (lambda W_=W_: ops.multidot_apply(W_, t)),
                          (lambda W_=W_: ref.multidot_ref(W_, t)),
                          (lambda W_=W_: torch.mv(W_.t(), t)), (m + 1) * n, 2 * m * n))
        V, z, gcc = Vw[:, :2 * l], Zw[:, l - 1], float(sc["gcc"])
        cases.append((f"window_axpy[m={2 * l}]", "window_axpy",
                      lambda: ops.window_axpy_apply(V, z, g, sc["gcc"]),
                      lambda: ref.window_axpy_ref(V, z, g, sc["gcc"]),
                      lambda: torch.addmv(z, V, g, beta=1 / gcc, alpha=-1 / gcc),
                      (2 * l + 2) * n, (4 * l + 1) * n))
        for label, kernel, run, plain, library, words, flops in cases:
            before = launch_counts()[kernel]
            got, want = run(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            abs_err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
            rel_err = max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
                          for a, b in zip(got, want))
            delta = launch_counts()[kernel] - before
            ms, plain_ms = timer(run), timer(plain)
            library_ms = timer(library) if library is not None else None
            bytes_ms = 1e3 * words * word / HBM_BYTES_PER_S
            ops_ms = 1e3 * flops / PEAK_FLOPS[dname]
            row = {"phase": "kernel", "check": label, "kernel": kernel, "dtype": dname, "n": n,
                   "l": l, "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": TOL[dname],
                   "launch_delta": delta, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bytes": words * word, "flops": flops,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            emit(row)
            check(delta == 1, f"{label} {dname}: launch counter moved by {delta}, not 1")
            check(rel_err <= TOL[dname], f"{label} {dname}: rel err {rel_err} > {TOL[dname]}")
            rows.append(row)
    return rows


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py runs from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs.poisson2d import CONFIG
    from repro_torch.core import Solver, chebyshev_shifts, solve
    from repro_torch.kernels import build, launch_counts, reset_launch_counts
    from repro_torch.launch import solve as launch_solve
    from repro_torch.operators import poisson2d

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    lib = build.load()
    spills = [ln.strip() for ln in lib.log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "cache_hit": lib.cache_hit,
          "library": str(lib.path.relative_to(ROOT)), "spill_lines": spills[:20]})

    nx, ny, l = CONFIG.nx, CONFIG.ny, CONFIG.l
    timer = Timer(torch)
    rows = kernel_checks(torch, timer, nx, l)
    del timer

    # ---- phase 4: the main path at full width --------------------------------
    dtype = getattr(torch, CONFIG.dtype)
    A = poisson2d(nx, ny)
    b = A @ torch.ones(A.n, dtype=dtype, device="cuda")
    sigma = chebyshev_shifts(CONFIG.lmin, CONFIG.lmax, l)
    reset_launch_counts()
    results = {}
    for backend in ("fused", "auto", None):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve(A, b, method="plcg_scan", l=l, tol=CONFIG.tol, maxiter=CONFIG.maxiter,
                  sigma=sigma, backend=backend, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        bodies = r.info["bodies"]
        true_rel = numpy_poisson_residual(r.x.cpu().numpy(), nx, ny)
        results[backend] = r
        emit({"phase": "main_path", "backend": backend, "grid": [nx, ny], "l": l,
              "dtype": CONFIG.dtype, "tol": CONFIG.tol, "maxiter": CONFIG.maxiter,
              "converged": r.converged, "iters": r.iters, "breakdowns": r.breakdowns,
              "restarts": r.restarts, "true_rel_residual": true_rel,
              "expected_from_jax_reference": EXPECTED, "seconds": dt, "bodies": bodies,
              "ms_per_body": 1e3 * dt / bodies, "launches": delta})
        check(r.converged and r.restarts == 0, f"backend={backend}: not converged cleanly")
        check(abs(r.iters - EXPECTED["iters"]) <= 2, f"backend={backend}: {r.iters} updates")
        check(true_rel <= 1e-4, f"backend={backend}: true residual {true_rel}")
        if backend == "fused":
            check(delta == {"fused_body": bodies, "multidot": 0, "window_axpy": 0},
                  f"fused launches {delta} for {bodies} bodies")
        elif backend == "auto":
            check(delta == {"fused_body": 0, "multidot": bodies + 2 * l - 1,
                            "window_axpy": bodies - l},
                  f"cuda-tier launches {delta} for {bodies} bodies")
        else:
            check(set(delta.values()) == {0}, f"backend=None launched kernels: {delta}")
    x_ref = results[None].x
    for backend in ("fused", "auto"):
        rel = float(torch.linalg.norm(results[backend].x - x_ref) / torch.linalg.norm(x_ref))
        emit({"phase": "main_path_agreement", "backend": backend, "vs": None,
              "iters_delta": results[backend].iters - results[None].iters, "x_rel_diff": rel})
        check(abs(results[backend].iters - results[None].iters) <= 2, f"{backend} iters vs None")
        check(rel <= 1e-6, f"{backend} x differs from backend=None by {rel}")

    t0 = time.perf_counter()
    r = launch_solve.main(["--backend", "fused"])
    emit({"phase": "cli", "command": "python -m repro_torch.launch.solve --backend fused",
          "converged": r.converged, "iters": r.iters, "seconds": time.perf_counter() - t0})
    check(r.converged, "the CLI solve did not converge")

    # ---- phase 5: a prepared Solver answering requests -----------------------
    t0 = time.perf_counter()
    solver = Solver(A, "plcg_scan", l=l, tol=CONFIG.tol, maxiter=CONFIG.maxiter, sigma=sigma,
                    backend="fused", device="cuda")
    setup = time.perf_counter() - t0
    for seed in (0, 1, 2):
        rb = A @ torch.from_numpy(np.random.default_rng(seed).standard_normal(A.n)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rr = solver.solve(rb)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rel = float(torch.linalg.norm(rb - A @ rr.x) / torch.linalg.norm(rb))
        emit({"phase": "solver_request", "seed": seed, "converged": rr.converged,
              "iters": rr.iters, "restarts": rr.restarts, "true_rel_residual": rel,
              "seconds": dt, "ms_per_body": 1e3 * dt / rr.info["bodies"],
              "setup_seconds": setup})
        check(rr.converged, f"Solver request seed={seed} did not converge")
    totals = launch_counts()
    emit({"phase": "main_path_launches", "launches": totals})
    for name, count in totals.items():
        check(count > 0, f"kernel {name} was never launched on the main path")

    # the shapes and mode each kernel runs in on the main path, at f64
    main_checks = {"fused_body": "fused_body[stencil,steady]",
                   "multidot": f"multidot[Z-dots,m={l}]", "window_axpy": f"window_axpy[m={2 * l}]"}
    summary = []
    for name, main_check in main_checks.items():
        row = next(r for r in rows if r["check"] == main_check and r["dtype"] == "float64")
        summary.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu", "replaces": REPLACES[name],
                        "launches": totals[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows
                                           if r["kernel"] == name and r["dtype"] == "float64"),
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
