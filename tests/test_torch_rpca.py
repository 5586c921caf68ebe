"""Robust PCA in the port (``core/rpca.py``) against the JAX package's
``rpca``: L, S and the residual history on the same matrices, and the
classic recovery of a synthetic low-rank plus sparse matrix
(``tests/test_core_hpa_rpca.py``'s case, its matrix drawn by JAX and handed
over as numpy).

f32 throughout. Tolerance: 1e-4 of the input's largest magnitude for L and S
and 1e-4 absolute for the residual history (both sides run the same
iteration; their SVDs round differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rpca import rpca as jax_rpca
from repro_torch.core import rpca
from repro_torch.core.prox import density, effective_rank_ratio


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors are tiny, and under a loaded suite
    more threads only contend with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("shape,n_iter,lam_scale,rho_mu", [
    ((40, 30), 30, 1.0, 1.2),
    ((24, 56), 20, 0.5, 1.5),
])
def test_rpca_matches_jax(shape, n_iter, lam_scale, rho_mu):
    rng = np.random.default_rng(shape[0])
    low = rng.standard_normal((shape[0], 3)) @ rng.standard_normal((3, shape[1]))
    spikes = (rng.random(shape) < 0.05) * rng.standard_normal(shape) * 4
    x = (low + spikes + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    l, s, hist = rpca(torch.from_numpy(x), n_iter=n_iter, lam_scale=lam_scale, rho_mu=rho_mu)
    jl, js, jh = jax_rpca(jnp.asarray(x), n_iter=n_iter, lam_scale=lam_scale, rho_mu=rho_mu)
    tol = 1e-4 * float(np.abs(x).max())
    assert hist.shape == (n_iter,)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=tol, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=tol, rtol=0)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jh), atol=1e-4, rtol=0)


def test_exact_recovery_synthetic():
    """JAX's synthetic case (rank 4 over 80 x 80, 5% spikes of 5): the port
    recovers L and S within 0.05 and converges below 1e-5, as JAX's test asks."""
    key = jax.random.PRNGKey(0)
    u = jax.random.normal(key, (80, 4)) / 2
    v = jax.random.normal(jax.random.fold_in(key, 1), (4, 80)) / 2
    l_true = np.asarray(u @ v)
    s_mask = np.asarray(jax.random.uniform(jax.random.fold_in(key, 2), (80, 80)) < 0.05)
    s_true = np.where(s_mask, 5.0, 0.0).astype(np.float32)
    l, s, hist = rpca(torch.from_numpy(l_true + s_true), n_iter=60)
    assert float(hist[-1]) < 1e-5
    np.testing.assert_allclose(l.numpy(), l_true, atol=0.05)
    np.testing.assert_allclose(s.numpy(), s_true, atol=0.05)


def test_weak_structure_on_random():
    """App. A in miniature: a generic random matrix does not split into a
    low-rank and a sparse part (rank stays high or S stays dense)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32))
    l, s, hist = rpca(x, n_iter=50)
    assert float(effective_rank_ratio(l)) > 0.3 or float(density(s, eps=1e-6)) > 0.3
    assert float(hist[-1]) < float(hist[0])
