"""The port's hand-written CUDA kernels against their plain versions, on
the card.  These tests need a CUDA card and skip without one (a skip is
not a pass: ``chip_smoke.py`` is the full check on the card).  The file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Bounds: 1e-12 relative at f64 and 1e-5 at f32 (the kernel and the plain
version sum in different orders).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops, ref

SCALARS = dict(s_warm=0.7, gam=1.3, dlt=0.9, dsub=0.4, gcc=1.1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(l, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    d = dict(Vw=rng.standard_normal((n, 2 * l + 1)), Zw=rng.standard_normal((n, l + 1)),
             t=rng.standard_normal(n), g=rng.standard_normal(2 * l))
    return {k: torch.from_numpy(v).to(device, dtype) for k, v in d.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil", [True, False], ids=["stencil", "streamed_t"])
@pytest.mark.parametrize("steady", [True, False], ids=["steady", "warmup"])
@pytest.mark.parametrize("l", [1, 3, 8])
@pytest.mark.parametrize("hw", [(12, 10), (1000, 1000), (257, 33)])
def test_fused_body_kernel_matches_plain(cuda_device, hw, l, steady, stencil, dtype):
    bound = 1e-12 if dtype == torch.float64 else 1e-5
    d = _inputs(l, hw[0] * hw[1], dtype, cuda_device)
    sc = {k: torch.tensor(v, dtype=dtype, device=cuda_device) for k, v in SCALARS.items()}
    kw = dict(l=l, steady=steady, g=d["g"], stencil_hw=hw if stencil else None, **sc)
    t = None if stencil else d["t"]
    reset_launch_counts()
    got = ops.fused_body_apply(d["Vw"], d["Zw"], t, **kw)
    assert launch_counts()["fused_body"] == 1
    want = ref.fused_body_ref(d["Vw"], d["Zw"], t, **kw)
    for name, a, b in zip(("Vw2", "Zw2", "dots"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) <= bound, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("l", [1, 3, 8])
@pytest.mark.parametrize("n", [120, 10**6, 77777])
def test_multidot_and_window_axpy_match_plain(cuda_device, n, l, dtype):
    """On the engine's strided views: Vw[:, :l+1], Zw[:, :l] (multidot) and
    Vw[:, :2l], Zw[:, l-1] (window_axpy)."""
    bound = 1e-12 if dtype == torch.float64 else 1e-5
    d = _inputs(l, n, dtype, cuda_device, seed=1)
    reset_launch_counts()
    for W, z in ((d["Vw"][:, :l + 1], d["t"]), (d["Zw"][:, :l], d["Zw"][:, 0])):
        assert _rel(ops.multidot_apply(W, z), ref.multidot_ref(W, z)) <= bound
    gcc = torch.tensor(1.1, dtype=dtype, device=cuda_device)
    args = (d["Vw"][:, :2 * l], d["Zw"][:, l - 1], d["g"], gcc)
    assert _rel(ops.window_axpy_apply(*args), ref.window_axpy_ref(*args)) <= bound
    assert launch_counts() == {"fused_body": 0, "multidot": 2, "window_axpy": 1}


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(cuda_device):
    """No float atomics: two launches on the same inputs agree exactly."""
    d = _inputs(3, 10**6, torch.float64, cuda_device, seed=2)
    sc = {k: torch.tensor(v, dtype=torch.float64, device=cuda_device)
          for k, v in SCALARS.items()}
    kw = dict(l=3, steady=True, g=d["g"], stencil_hw=(1000, 1000), **sc)
    first = ops.fused_body_apply(d["Vw"], d["Zw"], None, **kw)
    second = ops.fused_body_apply(d["Vw"], d["Zw"], None, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_fused_body_rejects_overlapping_output(cuda_device):
    d = _inputs(2, 120, torch.float64, cuda_device)
    with pytest.raises(ValueError, match="overlaps"):
        ops.fused_body_apply(d["Vw"], d["Zw"], d["t"], l=2, steady=True, g=d["g"],
                             out=(d["Vw"], torch.empty_like(d["Zw"])), **SCALARS)


@pytest.mark.cuda
def test_fused_solve_matches_inline_on_the_card(cuda_device):
    """A whole fused sweep on the card against backend=None on the card."""
    from repro_torch.core import solve
    from repro_torch.operators import poisson2d
    A = poisson2d(64, 48)
    b = A @ torch.ones(A.n, dtype=torch.float64, device=cuda_device)
    kw = dict(l=3, tol=1e-8, maxiter=500, spectrum=(0.0, 8.0), device=cuda_device)
    r0 = solve(A, b, backend=None, **kw)
    r1 = solve(A, b, backend="fused", **kw)
    assert r0.converged and r1.converged and abs(r0.iters - r1.iters) <= 1
    assert float(torch.linalg.norm(r1.x - r0.x) / torch.linalg.norm(r0.x)) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "cuda"])
def test_no_host_sync_per_body(cuda_device, backend):
    """The kernel path reads nothing back per body: a sweep of 60 bodies
    synchronizes with the host as often as one of 20 (both end before the
    first periodic ``done`` check at body 64)."""
    import warnings

    from repro_torch.core.plcg_scan import plcg_scan
    from repro_torch.operators import poisson2d
    A = poisson2d(64, 48)
    b = A @ torch.ones(A.n, dtype=torch.float64, device=cuda_device)

    def syncs(iters):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                plcg_scan(A.matvec, b, l=3, iters=iters, sigma=[7.0, 4.0, 1.0], tol=0.0,
                          backend=backend, stencil_hw=A.stencil2d, device=cuda_device)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    syncs(20)                                      # first use: build and load
    assert syncs(60) == syncs(20)


@pytest.mark.cuda
def test_launcher_profile_reports_device_time(cuda_device, capsys):
    """``--profile`` prints one JSON line with the device's share of a body."""
    import json

    from repro_torch.launch import solve as launch_solve
    r = launch_solve.main(["--nx", "64", "--iters", "30", "--tol", "0",
                           "--backend", "fused", "--profile"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["bodies"] == r.info["bodies"] and row["backend"] == "fused"
    assert row["device_busy_us_per_body"] > 0 and 0 <= row["device_idle_share"] < 1
