"""The dense limit-series step (K5, K6) and its edge-list form against the
JAX package.

CPU: the port's wrappers take their plain twins, held to the Pallas
kernels in interpret mode (as tests/test_kernels.py runs them) on the
same numpy inputs.  Tolerances: 1e-4 for fp32 (the bar of
tests/test_kernels.py: the two sum a 512-term product in other orders),
5e-2 for bf16 inputs (rounded to bf16 before both cast them to fp32, as
that test states), 1e-4 for the 11-step series.  tests/test_torch_cuda.py
holds the CUDA kernels to these twins on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.laplacian_poly import ops as jops
from repro_torch.core import backend, graphs, limit_neg_exp, operators
from repro_torch.core import laplacian as lap
from repro_torch.kernels.laplacian_poly import kernel, ops, ref

I = dict(interpret=True)
CPU = "cpu"


def _rand(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _sym(seed: int, n: int) -> np.ndarray:
    a = _rand(seed, (n, n))
    return a + a.T


@pytest.mark.parametrize("n", [128, 300, 512])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_poly_step_matches_pallas(n, k):
    l_mat, u = _sym(0, n), _rand(1, (n, k))
    want = np.asarray(jops.poly_step(jnp.asarray(l_mat), jnp.asarray(u),
                                     0.02, **I))
    got = ops.poly_step(torch.from_numpy(l_mat), torch.from_numpy(u), 0.02)
    assert got.dtype == torch.float32 and got.shape == (n, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_poly_step_dtypes_match_pallas(dtype):
    n, k = 256, 4
    l_mat, u = _rand(2, (n, n)), _rand(3, (n, k))
    jdt = getattr(jnp, dtype)
    want = np.asarray(jops.poly_step(jnp.asarray(l_mat, jdt),
                                     jnp.asarray(u, jdt), 0.1, **I))
    tdt = getattr(torch, dtype)
    got = ops.poly_step(torch.from_numpy(l_mat).to(tdt),
                        torch.from_numpy(u).to(tdt), 0.1)
    assert got.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_poly_step_holds_c_as_fp32():
    """c = 0.1 is not an fp32 number: both sides round it to fp32."""
    l_mat, u = torch.eye(4), torch.ones(4, 2)
    got = ref.poly_step(l_mat, u, 0.1)
    assert float(got[0, 0]) == float(np.float32(1) - np.float32(0.1))


@pytest.mark.parametrize("n", [256, 300])
def test_limit_series_apply_matches_pallas_and_series(n):
    """tests/test_kernels.py's series check: kernel path == core.series
    recurrence, here also == the JAX kernel path (ragged n = 300 too)."""
    k, deg = 3, 11
    l_mat = _sym(4, n) / 40
    v = _rand(5, (n, k))
    want = np.asarray(jops.limit_series_apply(
        jnp.asarray(l_mat), jnp.asarray(v), degree=deg, scale=1.5, **I))
    tl, tv = torch.from_numpy(l_mat), torch.from_numpy(v)
    got = ops.limit_series_apply(tl, tv, degree=deg, scale=1.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    series = limit_neg_exp(deg, scale=1.5).apply(operators.dense_matvec(tl), tv)
    np.testing.assert_allclose(got.numpy(), series.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), ref.limit_series_apply(tl, tv, deg, 1.5).numpy(),
        rtol=1e-6, atol=1e-6)


def test_dense_matvec_panel_is_the_product():
    l_mat, u = _sym(6, 300), _rand(7, (300, 5))
    got = ops.dense_matvec_panel(torch.from_numpy(l_mat), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), l_mat.astype(np.float64) @ u,
                               rtol=1e-4, atol=1e-4)


def test_limit_series_apply_edges_matches_series_node_blocked():
    """The edge-list form on the node-blocked layout (n = 8192 > the
    one-hot limit) against the port's own limit_neg_exp(...).apply over
    the plain segment matvec; 1e-5 max-abs, the TOL of
    tests/test_backend.py."""
    g, _ = graphs.sparse_sbm_graph(8192, 8, avg_degree_in=6,
                                   avg_degree_out=1, seed=0, device=CPU)
    nb = backend.blocking_for(g)
    rho = float(lap.spectral_radius_upper_bound(g))
    v = torch.from_numpy(_rand(8, (8192, 4)))
    got = ops.limit_series_apply_edges(nb, v, degree=15, scale=8.0 / rho)
    want = limit_neg_exp(15, scale=8.0 / rho).apply(
        lambda u: lap.laplacian_matvec(g, u), v)
    assert float((got - want).abs().max()) <= 1e-5
    one = ops.poly_step_edges(nb, v, 0.01)
    assert float((one - (v - 0.01 * lap.laplacian_matvec(g, v))).abs().max()) \
        <= 1e-5


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernel.poly_step(torch.eye(3), torch.ones(3, 1), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dense_matvec_panel(torch.eye(3), torch.ones(3, 1))
