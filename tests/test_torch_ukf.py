"""lsdtpu_torch.filter.ukf.ukf_step against lsdtpu.filter.ukf (f64, CPU):
within 1e-9 on random states and covariances, chained over many steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.filter import ukf as jukf
from lsdtpu_torch.filter import ukf as tukf

from torch_parity import np_


@pytest.mark.parametrize("seed", range(3))
def test_ukf_step_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=9) * 50
    A = rng.normal(size=(9, 9))
    P = A @ A.T + 9 * np.eye(9)
    jx, jP = jnp.asarray(x), jnp.asarray(P)
    tx, tP = torch.as_tensor(x), torch.as_tensor(P)
    for _ in range(25):
        sp = rng.normal(size=3)
        z = np.asarray(np_(jx))[:3] + rng.normal(size=3)
        jx, jP = jukf.ukf_step(jx, jP, jnp.asarray(sp), jnp.asarray(z))
        tx, tP = tukf.ukf_step(tx, tP, torch.as_tensor(sp),
                               torch.as_tensor(z))
        np.testing.assert_allclose(np_(tx), np_(jx), rtol=0, atol=1e-9)
        np.testing.assert_allclose(np_(tP), np_(jP), rtol=0, atol=1e-9)


def test_ukf_config_parameters_and_parts():
    rng = np.random.default_rng(9)
    A = rng.normal(size=(9, 9))
    P = A @ A.T + np.eye(9)
    np.testing.assert_allclose(
        np_(tukf._cholesky_unrolled(torch.as_tensor(P))),
        np.linalg.cholesky(P), atol=1e-12)
    M = rng.normal(size=(3, 3)) + 3 * np.eye(3)
    np.testing.assert_allclose(np_(tukf._inv3(torch.as_tensor(M))),
                               np.linalg.inv(M), atol=1e-12)
    x = rng.normal(size=9)
    kw = dict(alpha=0.5, beta=1.0, kappa=1.0, dt_step=0.5)
    want = jukf.ukf_step(jnp.asarray(x), jnp.asarray(P), jnp.ones(3),
                         jnp.zeros(3), **kw)
    got = tukf.ukf_step(torch.as_tensor(x), torch.as_tensor(P),
                        torch.ones(3, dtype=torch.float64),
                        torch.zeros(3, dtype=torch.float64), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), atol=1e-9)
