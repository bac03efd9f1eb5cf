"""The port's GMM fits and summary statistics against the JAX package.

- Host path (`fit_gmm_best_aic`, numpy in both packages): equal bit for
  bit from the same seed and rows.
- Batched EM (`_em_fits`): the port's torch loop against the JAX package's
  jitted `lax.while_loop`, on the same k-means++ start, float64 on the CPU:
  means, covariances, weights and logl within rtol 1e-8, the same
  convergence and singular flags.
- Whole-ladder fit (`fit_gmm_best_aic_device_multi`): the same component
  count selected per history, parameters within rtol 1e-8.
- `summary` and `analysis` ESS: equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu import analysis as janalysis
from bcm3_tpu.stats import gmm as jgmm
from bcm3_tpu.stats import gmm_device as jgd
from bcm3_tpu.stats import summary as jsummary
from bcm3_tpu_torch import analysis as tanalysis
from bcm3_tpu_torch.stats import gmm as tgmm
from bcm3_tpu_torch.stats import gmm_device as tgd
from bcm3_tpu_torch.stats import summary as tsummary

RTOL = 1e-8


def _mixture(seed, n=300, D=5):
    """Two well-separated clusters and a correlated third, (n, D)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 1.0, (n // 3, D))
    b = rng.normal(3.0, 0.5, (n // 3, D))
    c = rng.normal(0.0, 1.0, (n - 2 * (n // 3), D)) @ np.tril(np.full((D, D), 0.4)) - 2.0
    return np.concatenate([a, b, c])[rng.permutation(n)]


@pytest.mark.parametrize("adjusted", [False, True], ids=["aic", "adjusted_aic"])
def test_fit_gmm_best_aic_bit_for_bit(adjusted):
    x = _mixture(1)
    got = tgmm.fit_gmm_best_aic(x, np.random.default_rng(3), select_with_adjusted_aic=adjusted)
    ref = jgmm.fit_gmm_best_aic(x, np.random.default_rng(3), select_with_adjusted_aic=adjusted)
    assert got.num_components == ref.num_components > 1
    for f in ("means", "covariances", "chols", "weights", "log_c"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.logl == ref.logl and got.aic == ref.aic


@pytest.mark.parametrize(
    "k,ess_factor",
    [(3, 1.0), (4, 80.0)],
    ids=["full_covariance", "diag_only_branch"],
)
def test_em_fits_match_jax(k, ess_factor):
    """Four fits of one dataset from four k-means++ starts. At ess_factor
    80 the effective counts of small components fall below 2, so the
    M-step takes its diagonal-only branch."""
    x = _mixture(2)
    rng = np.random.default_rng(k)
    resp0 = np.stack([jgmm._kmeanspp(x, k, rng) for _ in range(4)])
    F, (n, D) = len(resp0), x.shape
    args = (np.broadcast_to(x, (F, n, D)).copy(), resp0, np.ones((F, k), bool),
            np.full(F, ess_factor))
    ref = [np.asarray(a) for a in jgd._em_fits(*(jnp.asarray(a) for a in args))]
    got = tgd._em_fits(*(torch.as_tensor(a) for a in args))
    for name, r, g in zip(("means", "covs", "weights", "logl"), ref[:4], got[:4]):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=1e-12, err_msg=name)
    for name, r, g in zip(("converged", "singular"), ref[4:], got[4:6]):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert ref[4].all()
    steps, edge, trips = got[6].numpy(), got[7].numpy(), got[8]
    assert (steps >= 1).all() and trips >= steps.max()
    # these fits stay clear of the singular test's rounding edge
    assert (edge > 1e3).all(), edge


def test_fit_gmm_best_aic_device_multi_matches_jax():
    """Histories on which the two LAPACKs decide every singular test
    alike. At the test's edge (a component with about D points or fewer,
    its correlation eigenvalues near 0) the sign of eigh's rounding decides
    the singular flag, and two LAPACKs may decide it apart: then another
    retry is selected, as happens for some seeds at D = 4 to 10 (see
    test_em_course_departs_only_at_the_singular_edge)."""
    hs = [_mixture(5, 600, 8), _mixture(6, 600, 8)[::-1] + 0.1]
    ref = jgd.fit_gmm_best_aic_device_multi(hs, np.random.default_rng(7))
    stats = {}
    got = tgd.fit_gmm_best_aic_device_multi(hs, np.random.default_rng(7), device="cpu", stats=stats)
    for g, r in zip(got, ref):
        assert g.num_components == r.num_components
        for f in ("means", "covariances", "weights"):
            np.testing.assert_allclose(getattr(g, f), getattr(r, f), rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(g.aic, r.aic, rtol=RTOL)
    # every eligible k of every history ran its 4 retries
    assert stats["fits"][2] == 8 and all(v % 4 == 0 for v in stats["fits"].values())
    assert max(stats["em_steps"].values()) <= tgmm._MAX_EM_STEPS


def test_em_course_departs_only_at_the_singular_edge(monkeypatch):
    """eigh's input perturbed at the 1e-16 level, as another LAPACK's
    rounding would perturb it: a fit may take another course (stop at
    another step, or flip a flag) only where its edge, the singular test's
    least margin, is at rounding level (here the components of about D
    points). Every fit of the same course agrees within rtol 1e-8."""
    x = _mixture(9, 120, 6)
    rng = np.random.default_rng(4)
    F, k, (n, D) = 16, 5, x.shape
    resp0 = np.stack([tgmm._kmeanspp(x, k, rng) for _ in range(F)])
    args = [torch.as_tensor(a) for a in (
        np.broadcast_to(x, (F, n, D)).copy(), resp0, np.ones((F, k), bool), np.ones(F))]
    plain = tgd._em_fits(*args)
    eigh = torch.linalg.eigh

    def perturbed(a):
        noise = torch.randn(a.shape, generator=torch.Generator().manual_seed(0), dtype=a.dtype)
        return eigh(a + 0.5e-16 * (noise * a.abs() + (noise * a.abs()).transpose(-1, -2)))

    monkeypatch.setattr(torch.linalg, "eigh", perturbed)
    other = tgd._em_fits(*args)
    edge = np.minimum(plain[7].numpy(), other[7].numpy()) < 1e3
    differs = np.zeros(F, dtype=bool)
    for i in (4, 5, 6):  # converged, singular, E-steps
        differs |= plain[i].numpy() != other[i].numpy()
    assert edge.any() and (~edge).any()
    assert not (differs & ~edge).any()
    for name, i in (("means", 0), ("covs", 1), ("weights", 2), ("logl", 3)):
        a, b = plain[i].numpy()[~differs], other[i].numpy()[~differs]
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-10 * np.abs(b).max(), err_msg=name)


def test_ess_matches_jax():
    rng = np.random.default_rng(8)
    y = np.zeros((400, 6))
    for t in range(1, 400):  # AR(1) columns of rising correlation
        y[t] = np.linspace(0.0, 0.95, 6) * y[t - 1] + rng.normal(size=6)
    for j in range(6):
        assert tsummary.effective_sample_size(y[:, j]) == jsummary.effective_sample_size(y[:, j])
        assert tsummary.acf(y[:, j], 3) == jsummary.acf(y[:, j], 3)
        assert tanalysis.effective_sample_size(y[:, j]) == janalysis.effective_sample_size(y[:, j])
    np.testing.assert_array_equal(
        tanalysis.effective_sample_size_batched(y), janalysis.effective_sample_size_batched(y)
    )
    np.testing.assert_array_equal(tsummary.cov(y), jsummary.cov(y))
