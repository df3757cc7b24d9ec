"""Parity of the port's kernel plain versions with the JAX kernels.

The same seeded numpy inputs go through the JAX Pallas kernels (interpret
mode on the CPU, via ``repro.kernels.ops.*_apply(use_pallas=True)``) and
through ``repro_torch.kernels.ops.*_apply`` on CPU tensors, which take the
plain PyTorch versions.  A 12x10 grid keeps the stencil's row width off a
power of two.  Bounds: 1e-12 relative at f64 (the repository's tier bound,
``tests/test_backend_parity.py``) and 1e-5 at f32 (the two sides sum in
different orders).

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against the plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

H, W = 12, 10
N = H * W
BOUND = {np.float64: 1e-12, np.float32: 1e-5}
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}
SCALARS = dict(s_warm=0.7, gam=1.3, dlt=0.9, dsub=0.4, gcc=1.1)


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True)
def no_launches():
    """The CPU route never launches a CUDA kernel."""
    reset_launch_counts()
    yield
    assert set(launch_counts().values()) == {0}


def _inputs(l, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return dict(Vw=rng.standard_normal((N, 2 * l + 1)).astype(dtype),
                Zw=rng.standard_normal((N, l + 1)).astype(dtype),
                t=rng.standard_normal(N).astype(dtype),
                g=rng.standard_normal(2 * l).astype(dtype))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("stencil", [True, False], ids=["stencil", "streamed_t"])
@pytest.mark.parametrize("steady", [True, False], ids=["steady", "warmup"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_fused_body_matches_jax_kernel(l, steady, stencil, dtype):
    d = _inputs(l, dtype)
    hw = (H, W) if stencil else None
    t = None if stencil else d["t"]
    jscal = {k: jnp.asarray(v, dtype) for k, v in SCALARS.items()}
    want = jops.fused_body_apply(
        jnp.asarray(d["Vw"]), jnp.asarray(d["Zw"]), None,
        None if t is None else jnp.asarray(t), None, l=l, steady=jnp.bool_(steady),
        g=jnp.asarray(d["g"]), stencil_hw=hw, use_pallas=True, **jscal)
    tscal = {k: torch.tensor(v, dtype=TORCH_DTYPE[dtype]) for k, v in SCALARS.items()}
    got = tops.fused_body_apply(
        torch.from_numpy(d["Vw"]), torch.from_numpy(d["Zw"]),
        None if t is None else torch.from_numpy(t), l=l, steady=steady,
        g=torch.from_numpy(d["g"]), stencil_hw=hw, **tscal)
    for name, a, b in zip(("Vw2", "Zw2", "dots"), got, (want[0], want[1], want[3])):
        assert a.dtype == TORCH_DTYPE[dtype], name
        assert _rel(a, b) <= BOUND[dtype], name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_multidot_matches_jax_kernel(l, dtype):
    """The V-dots and Z-dots of a body, on the strided window views the
    engine passes."""
    d = _inputs(l, dtype, seed=1)
    for W_, z_ in ((d["Vw"][:, :l + 1], d["t"]), (d["Zw"][:, :l], d["Zw"][:, 0])):
        want = jops.multidot_apply(jnp.asarray(W_), jnp.asarray(z_), use_pallas=True)
        got = tops.multidot_apply(torch.from_numpy(W_), torch.from_numpy(z_))
        assert got.dtype == TORCH_DTYPE[dtype]
        assert _rel(got, want) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_window_axpy_matches_jax_kernel(l, dtype):
    """v = (z - V g) / gcc on the engine's views Vw[:, :2l] and Zw[:, l-1]."""
    d = _inputs(l, dtype, seed=2)
    V, z = d["Vw"][:, :2 * l], d["Zw"][:, l - 1]
    want = jops.window_axpy_apply(jnp.asarray(V), jnp.asarray(z), jnp.asarray(d["g"]),
                                  jnp.asarray(1.1, dtype), use_pallas=True)
    Vt, Zt = torch.from_numpy(d["Vw"]), torch.from_numpy(d["Zw"])
    got = tops.window_axpy_apply(Vt[:, :2 * l], Zt[:, l - 1], torch.from_numpy(d["g"]),
                                 torch.tensor(1.1, dtype=Vt.dtype))
    assert got.dtype == Vt.dtype
    assert _rel(got, want) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stencil2d_ref_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x, hn, hs = (rng.standard_normal(s).astype(dtype) for s in ((H, W), W, W))
    hw, he = (rng.standard_normal(H).astype(dtype) for _ in range(2))
    want = jref.stencil2d_ref(*map(jnp.asarray, (x, hn, hs, hw, he)))
    got = tref.stencil2d_ref(*map(torch.from_numpy, (x, hn, hs, hw, he)))
    assert _rel(got, want) <= BOUND[dtype]


def test_kernel_wrappers_reject_mixed_devices():
    x = torch.zeros(4, 2, dtype=torch.float64)
    meta = torch.zeros(4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tops.multidot_apply(x, meta)
