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
from repro_torch.kernels.ref import FUSED_BODY_MODES

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
             Zhw=rng.standard_normal((n, 3)), t=rng.standard_normal(n),
             t_hat=rng.standard_normal(n), invd=rng.uniform(0.2, 0.3, n),
             g=rng.standard_normal(2 * l))
    return {k: torch.from_numpy(v).to(device, dtype) for k, v in d.items()}


def _mode_operands(mode, d, hw):
    """(Zhw, t, t_hat, invd, stencil_hw) of one fused_body mode."""
    stencil, zh, diag = FUSED_BODY_MODES[mode]
    invd = {"none": None, "scalar": torch.tensor(0.25, dtype=d["Vw"].dtype,
                                                 device=d["Vw"].device),
            "vector": d["invd"]}[diag]
    streams_t = not stencil and diag == "none"
    return (d["Zhw"] if zh else None, d["t"] if streams_t else None,
            d["t_hat"] if zh and not stencil else None, invd, hw if stencil else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", list(FUSED_BODY_MODES),
                         ids=[{"t": "streamed_t"}.get(m, m) for m in FUSED_BODY_MODES])
@pytest.mark.parametrize("steady", [True, False], ids=["steady", "warmup"])
@pytest.mark.parametrize("l", [1, 3, 8])
@pytest.mark.parametrize("hw", [(12, 10), (1000, 1000), (257, 33)])
def test_fused_body_kernel_matches_plain(cuda_device, hw, l, steady, mode, dtype):
    bound = 1e-12 if dtype == torch.float64 else 1e-5
    d = _inputs(l, hw[0] * hw[1], dtype, cuda_device)
    Zhw, t, t_hat, invd, stencil_hw = _mode_operands(mode, d, hw)
    sc = {k: torch.tensor(v, dtype=dtype, device=cuda_device) for k, v in SCALARS.items()}
    kw = dict(l=l, steady=steady, g=d["g"], invd=invd, stencil_hw=stencil_hw, **sc)
    reset_launch_counts()
    got = ops.fused_body_apply(d["Vw"], d["Zw"], Zhw, t, t_hat, **kw)
    assert launch_counts()["fused_body"] == 1
    want = ref.fused_body_ref(d["Vw"], d["Zw"], Zhw, t, t_hat, **kw)
    assert (got[2] is None) == (want[2] is None) == (Zhw is None)
    for name, a, b in zip(("Vw2", "Zw2", "Zhw2", "dots"), got, want):
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert _rel(a, b) <= bound, name


def _halos(H, W, dtype, device, zero, seed=0):
    rng = np.random.default_rng(seed)
    make = (lambda m: np.zeros(m)) if zero else rng.standard_normal
    return [torch.from_numpy(make(m)).to(device, dtype) for m in (W, W, H, H)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("zero_halos", [True, False], ids=["zero_halos", "random_halos"])
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "window_column"])
@pytest.mark.parametrize("hw", [(12, 10), (1000, 1000), (257, 33), (1, 7)])
def test_stencil2d_kernel_matches_plain(cuda_device, hw, strided, zero_halos, dtype):
    """Bit for bit against the plain version (same operation order, no
    reduction), on a contiguous block and on the column Zw[:, 0] of a
    window viewed as (H, W), as the engine's split path passes it; two
    launches agree exactly."""
    H, W = hw
    rng = np.random.default_rng(1)
    if strided:
        Zw = torch.from_numpy(rng.standard_normal((H * W, 4))).to(cuda_device, dtype)
        x = Zw[:, 0].unflatten(0, hw)
    else:
        x = torch.from_numpy(rng.standard_normal(hw)).to(cuda_device, dtype)
    halos = _halos(H, W, dtype, cuda_device, zero_halos)
    reset_launch_counts()
    got = ops.stencil2d_apply(x, *halos)
    again = ops.stencil2d_apply(x, *halos)
    assert launch_counts()["stencil2d"] == 2
    want = ref.stencil2d_ref(x, *halos)
    assert got.dtype == want.dtype and got.shape == want.shape == hw
    assert torch.equal(got, want) and torch.equal(got, again)


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
    assert launch_counts() == {"fused_body": 0, "multidot": 2, "stencil2d": 0,
                               "window_axpy": 1}


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(cuda_device):
    """No float atomics: two launches on the same inputs agree exactly."""
    d = _inputs(3, 10**6, torch.float64, cuda_device, seed=2)
    sc = {k: torch.tensor(v, dtype=torch.float64, device=cuda_device)
          for k, v in SCALARS.items()}
    for mode in ("stencil", "stencil+zh+scalar", "t+t_hat+zh"):
        Zhw, t, t_hat, invd, hw = _mode_operands(mode, d, (1000, 1000))
        kw = dict(l=3, steady=True, g=d["g"], invd=invd, stencil_hw=hw, **sc)
        first = ops.fused_body_apply(d["Vw"], d["Zw"], Zhw, t, t_hat, **kw)
        second = ops.fused_body_apply(d["Vw"], d["Zw"], Zhw, t, t_hat, **kw)
        assert all(a is b is None or torch.equal(a, b) for a, b in zip(first, second)), mode


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["Vw", "Zhw", "t_hat", "invd"])
def test_fused_body_rejects_overlapping_output(cuda_device, target):
    """No output window may overlap any input: Vw2 written over Vw, Zhw2
    over Zhw, or Zw2 sharing storage with the streamed t_hat / the invd
    operand."""
    d = _inputs(2, 120, torch.float64, cuda_device)
    mode = "t_hat+zh+vector" if target == "invd" else "t+t_hat+zh"
    out = {k: torch.empty_like(d[k]) for k in ("Vw", "Zw", "Zhw")}
    if target in ("Vw", "Zhw"):
        out[target] = d[target]
    else:
        shared = torch.empty(d["Zw"].numel(), dtype=torch.float64, device=cuda_device)
        shared[:120] = d[target]
        d[target] = shared[:120]
        out["Zw"] = shared.view(d["Zw"].shape)
    Zhw, t, t_hat, invd, _ = _mode_operands(mode, d, None)
    with pytest.raises(ValueError, match="overlaps"):
        ops.fused_body_apply(d["Vw"], d["Zw"], Zhw, t, t_hat, l=2, steady=True, g=d["g"],
                             invd=invd, out=(out["Vw"], out["Zw"], out["Zhw"]), **SCALARS)


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


@pytest.mark.cuda
@pytest.mark.parametrize("prec, per_body", [
    ("jacobi", {"fused_body": 1, "stencil2d": 0}),
    ("blockjacobi", {"fused_body": 1, "stencil2d": 1}),
    ("chebyshev", {"fused_body": 1, "stencil2d": 1}),
])
def test_preconditioned_fused_launches_per_body(cuda_device, prec, per_body):
    """The launch contract of backend="fused" under a preconditioner: a
    diagonal one stays at ONE fused_body launch a body (stencil and diag
    apply in the kernel); a general one takes stencil2d + fused_body."""
    from repro_torch.core import BlockJacobi, Chebyshev
    from repro_torch.core.plcg_scan import plcg_scan
    from repro_torch.operators import jacobi, poisson2d
    A = poisson2d(64, 48)
    M = {"jacobi": lambda: jacobi(A), "blockjacobi": lambda: BlockJacobi((64, 48)),
         "chebyshev": lambda: Chebyshev(A)}[prec]()
    b = A @ torch.ones(A.n, dtype=torch.float64, device=cuda_device)
    reset_launch_counts()
    out = plcg_scan(A.matvec, b, l=3, iters=40, sigma=[1.8, 1.0, 0.2], tol=0.0, prec=M,
                    prec_diag=M.inv_diag, backend="fused", stencil_hw=A.stencil2d,
                    device=cuda_device)
    assert out.bodies == 40
    counts = launch_counts()
    assert {k: counts[k] for k in per_body} == {k: v * 40 for k, v in per_body.items()}
    assert counts["multidot"] == counts["window_axpy"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["jacobi", "blockjacobi", "chebyshev"])
def test_preconditioned_fused_solve_matches_inline_on_the_card(cuda_device, prec):
    from repro_torch.core import BlockJacobi, Chebyshev, solve
    from repro_torch.operators import jacobi, poisson2d
    A = poisson2d(64, 48)
    M = {"jacobi": lambda: jacobi(A), "blockjacobi": lambda: BlockJacobi((64, 48)),
         "chebyshev": lambda: Chebyshev(A)}[prec]()
    b = A @ torch.ones(A.n, dtype=torch.float64, device=cuda_device)
    kw = dict(l=3, tol=1e-8, maxiter=500, M=M, device=cuda_device)
    r0 = solve(A, b, backend=None, **kw)
    r1 = solve(A, b, backend="fused", **kw)
    assert r0.converged and r1.converged and abs(r0.iters - r1.iters) <= 2
    assert float(torch.linalg.norm(r1.x - r0.x) / torch.linalg.norm(r0.x)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(1, 1), (2, 2)])
def test_blockjacobi_spectrum_on_the_card_matches_cpu(cuda_device, blocks):
    """The power iteration runs on the solve's device, in float64 from the
    same numpy start vector: the card's estimate is the CPU's to 1e-12."""
    from repro_torch.core import BlockJacobi
    on_card = BlockJacobi((64, 48), blocks=blocks).precond_spectrum(device=cuda_device)
    on_cpu = BlockJacobi((64, 48), blocks=blocks).precond_spectrum()
    assert on_card[0] == on_cpu[0] == 0.0
    assert on_card[1] == pytest.approx(on_cpu[1], rel=1e-12, abs=0)
