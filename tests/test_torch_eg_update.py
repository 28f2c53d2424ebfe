"""The fused mu-EG update (K3 gram2k, K4 panel_mix) against the JAX package.

CPU: the port's wrappers take their plain twins, held to the JAX oracle
(`ref`) and, at tiny sizes, to the Pallas kernels in interpret mode.
Tolerance 1e-5 max-abs (the TOL of tests/test_backend.py) on unit-scale
panels; the gram, a sum over n rows, is held to 1e-5 of its scale.
tests/test_torch_cuda.py holds the CUDA kernels to these twins on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.eg_update import kernel as jkernel
from repro.kernels.eg_update import ops as jops
from repro.kernels.eg_update import ref as jref
from repro_torch.kernels.eg_update import kernel, ops, ref

TOL = 1e-5


def _panels(seed: int, n: int, k: int):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, k)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    av = (rng.normal(size=(n, k)) / np.sqrt(n)).astype(np.float32)
    return v, av


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("n,k,lr", [(300, 6, 0.05), (97, 3, 0.4), (64, 10, 1.0)])
def test_mu_eg_update_matches_jax(n, k, lr):
    v, av = _panels(n + k, n, k)
    want = jref.mu_eg_update(jnp.asarray(v), jnp.asarray(av), lr)
    tv, tav = torch.from_numpy(v), torch.from_numpy(av)
    assert _maxabs(ref.mu_eg_update(tv, tav, lr).numpy(), want) <= TOL
    assert _maxabs(ops.mu_eg_update(tv, tav, lr).numpy(), want) <= TOL


@pytest.mark.parametrize("k,lr", [(4, 0.1), (10, 0.4)])
def test_coefficient_matrices_match_jax(k, lr):
    v, av = _panels(5, 200, k)
    x = np.concatenate([v, av], axis=1)
    s2 = x.T @ x
    for got, want in zip(ref.coefficient_matrices(torch.from_numpy(s2), k, lr),
                         jref.coefficient_matrices(jnp.asarray(s2), k, lr)):
        assert _maxabs(got.numpy(), want) <= TOL * max(1.0, float(np.max(np.abs(want))))


def test_plain_twins_recompose_the_update():
    v, av = _panels(6, 150, 5)
    tv, tav = torch.from_numpy(v), torch.from_numpy(av)
    s2 = ref.gram2k(tv, tav)
    m1, m2, cs = ref.coefficient_matrices(s2, 5, 0.3)
    torch.testing.assert_close(ref.panel_mix(tv, tav, m1, m2, cs),
                               ref.mu_eg_update(tv, tav, 0.3), atol=TOL, rtol=0)


def test_k3_pallas_interpret_matches_port():
    v, av = _panels(7, 64, 8)
    want = jkernel.gram2k(jnp.asarray(v), jnp.asarray(av), block_n=32,
                          interpret=True)
    got = ops.gram2k(torch.from_numpy(v), torch.from_numpy(av))
    assert got.shape == (16, 16)
    assert _maxabs(got.numpy(), want) <= TOL * max(1.0, float(np.max(np.abs(want))))


def test_k4_pallas_interpret_matches_port():
    v, av = _panels(8, 64, 8)
    rng = np.random.default_rng(9)
    m1, m2 = (rng.normal(size=(8, 8)).astype(np.float32) for _ in range(2))
    cs = rng.uniform(0.5, 2.0, size=8).astype(np.float32)
    want = jkernel.panel_mix(*(jnp.asarray(a) for a in (v, av, m1, m2, cs)),
                             block_n=32, interpret=True)
    got = ops.panel_mix(*(torch.from_numpy(a) for a in (v, av, m1, m2, cs)))
    assert _maxabs(got.numpy(), want) <= TOL


def test_fused_update_pallas_interpret_matches_port():
    v, av = _panels(10, 100, 5)
    want = jops.mu_eg_update(jnp.asarray(v), jnp.asarray(av), 0.2,
                             block_n=32, interpret=True)
    got = ops.mu_eg_update(torch.from_numpy(v), torch.from_numpy(av), 0.2)
    assert _maxabs(got.numpy(), want) <= TOL


def test_kernel_wrappers_refuse_cpu_tensors():
    v, av = (torch.from_numpy(a) for a in _panels(11, 10, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gram2k(v, av)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.panel_mix(v, av, torch.eye(2), torch.eye(2), torch.ones(2))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 5000, 1 << 20])
def test_gram_row_slices_cover_the_panel(n):
    """The first gram launch's row slices: at most GRAM_BLOCKS_PER_SM per
    SM, whole tiles each, none empty, covering all n rows."""
    for k, sms in ((1, 1), (7, 132), (10, 132), (64, 114), (192, 16)):
        parts, rows = kernel.gram2k_parts(n, k, sms)
        tile_rows = kernel.gram2k_tile_rows(k)
        assert 1 <= parts <= kernel.GRAM_BLOCKS_PER_SM * sms
        assert rows % tile_rows == 0
        assert tile_rows * k <= kernel.GRAM_TILE_FLOATS
        assert (parts - 1) * rows < n <= parts * rows
