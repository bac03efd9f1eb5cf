"""The port's spectral clustering against the JAX package's.

- The fit (numpy in both packages) is bit-identical for the same seed, its
  dump included, and leaves the host RNG in the same state.
- `assign_batch` (direct differences) gives the JAX `assign_batch`'s labels
  and `assign_history` the JAX `assign_host`'s, on 576 queries of which 64
  are stored samples, float64; cutting the rows into chunks changes no
  label.
- A JAX ClusterAssigner carried across by bcm3_tpu_torch.convert assigns
  as the JAX package does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.sampler import spectral as jspec
from bcm3_tpu_torch import convert
from bcm3_tpu_torch.sampler import spectral as tspec

D, K = 6, 3
FIT = dict(nn=3, nn2=7, num_clusters=K, max_samples=300)


def _mixture(rng, n):
    """Three elongated Gaussian clusters in D = 6."""
    centers = np.array([[-4.0] * D, [0.0] * D, [4.0] + [0.0] * (D - 1)])
    centers[2, 1] = 5.0
    shape = np.eye(D) + 0.4 * np.random.default_rng(3).normal(size=(D, D))
    return centers[rng.integers(0, K, n)] + 0.8 * rng.normal(size=(n, D)) @ shape


@pytest.fixture(scope="module")
def fits():
    history = _mixture(np.random.default_rng(1), 600)
    # repeated rows, as a chain that rejects leaves them: the fit keeps the
    # first of each
    history = np.concatenate([history, history[::7], history[:5]])
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    jdump, tdump = {}, {}
    jasg = jspec.fit_spectral_clustering(history, rng=jrng, dump_sink=jdump, **FIT)
    tasg = tspec.fit_spectral_clustering(history, rng=trng, dump_sink=tdump, device="cpu", **FIT)
    rng = np.random.default_rng(2)
    stored = tasg.scaled_samples.numpy()[rng.choice(FIT["max_samples"], 64, replace=False)]
    queries = np.concatenate([_mixture(rng, 512), stored * tasg.variable_scaling.numpy()])
    return dict(history=history, rngs=(jrng, trng), dumps=(jdump, tdump),
                jasg=jasg, tasg=tasg, queries=queries)


def test_fit_is_bit_identical(fits):
    jasg, tasg = fits["jasg"], fits["tasg"]
    assert (tasg.nn, tasg.nn2, tasg.num_clusters) == (jasg.nn, jasg.nn2, K)
    for f in tspec.ARRAY_FIELDS:
        t = getattr(tasg, f)
        assert t.dtype == torch.float64
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jasg, f)), err_msg=f)
    jdump, tdump = fits["dumps"]
    assert set(tdump) == set(jdump) and "K" in tdump
    for k in jdump:
        np.testing.assert_array_equal(tdump[k], jdump[k], err_msg=k)
    jrng, trng = fits["rngs"]
    assert jrng.bit_generator.state == trng.bit_generator.state
    # the fit found the three clusters
    labels = tspec.assign_history(tasg, torch.as_tensor(fits["history"]))
    assert np.bincount(labels.numpy(), minlength=K).min() > 150


def test_distinct_rows_are_numpys(fits):
    """The fit's distinct rows (found with torch) are np.unique's, signed
    zeros equal as there."""
    h32 = fits["history"].astype(np.float32)
    h32[3, 0], h32[4] = 0.0, h32[3]
    h32[4, 0] = -0.0
    _, ref = np.unique(h32, axis=0, return_index=True)
    got = tspec._first_unique_rows(h32, "cpu")
    np.testing.assert_array_equal(got, np.sort(ref))
    assert 3 in got and 4 not in got and len(got) < len(h32)


@pytest.mark.parametrize("max_bytes", [tspec.CHUNK_BYTES, 300 * D * 8 * 50], ids=["whole", "chunks"])
def test_assign_batch_matches_jax(fits, max_bytes):
    """The mutate path's assignment: labels equal on every query; the small
    budget cuts the 576 queries into chunks of 50."""
    q = fits["queries"]
    ref = np.asarray(jspec.assign_batch(fits["jasg"], jnp.asarray(q)))
    got = tspec.assign_batch(fits["tasg"], torch.as_tensor(q), max_bytes=max_bytes)
    assert got.shape == (len(q),) and len(np.unique(ref)) == K
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("max_bytes", [tspec.CHUNK_BYTES, 300 * 8 * 37], ids=["whole", "chunks"])
def test_assign_history_matches_jax_assign_host(fits, max_bytes):
    """The boundary's labelling: labels equal to the JAX package's host
    loop on every query; float32 rows (as the history stores them) give
    the labels of their float64 values."""
    q = fits["queries"]
    ref = jspec.assign_host(fits["jasg"], q)
    got = tspec.assign_history(fits["tasg"], torch.as_tensor(q), max_bytes=max_bytes)
    np.testing.assert_array_equal(got.numpy(), ref)
    q32 = q.astype(np.float32)
    np.testing.assert_array_equal(
        tspec.assign_history(fits["tasg"], torch.as_tensor(q32)).numpy(),
        jspec.assign_host(fits["jasg"], q32.astype(np.float64)),
    )


def test_scores_pick_the_labels(fits):
    """The centroid scores behind each assignment: the label is their
    argmax, and the two formulas' scores agree to rounding."""
    q = torch.as_tensor(fits["queries"])
    a = fits["tasg"]
    sb, sh = tspec.batch_scores(a, q), tspec.history_scores(a, q)
    assert sb.shape == (len(q), K)
    assert torch.equal(sb.argmax(-1), tspec.assign_batch(a, q))
    torch.testing.assert_close(sb, sh, rtol=1e-9, atol=1e-12)


def test_assigner_carries_across(fits):
    jasg = fits["jasg"]
    asg = convert.cluster_assigner_from_arrays(
        {f: np.asarray(getattr(jasg, f)) for f in convert.ASSIGNER_FIELDS},
        {m: getattr(jasg, m) for m in convert.ASSIGNER_META},
        "cpu",
    )
    q = fits["queries"]
    np.testing.assert_array_equal(
        tspec.assign_batch(asg, torch.as_tensor(q)).numpy(),
        np.asarray(jspec.assign_batch(jasg, jnp.asarray(q))),
    )
    assert torch.equal(asg.bitset_t, asg.nn_bitset.T)


@pytest.mark.parametrize("case", ["constant", "too_few_unique"])
def test_degenerate_history_fits_nothing(case):
    """No fit where the JAX package fits none: a variable without spread,
    or fewer unique rows than nn2 + 1; the host RNG is not touched."""
    x = np.ones((50, 3)) if case == "constant" else np.repeat(np.eye(3), 4, axis=0)
    rng = np.random.default_rng(0)
    state = rng.bit_generator.state
    assert jspec.fit_spectral_clustering(x, 3, 7, 2, 100, np.random.default_rng(0)) is None
    assert tspec.fit_spectral_clustering(x, 3, 7, 2, 100, rng, "cpu") is None
    assert rng.bit_generator.state == state


def test_fit_runs_on_the_card_unless_asked():
    """A direct caller of the public fit gets the card by default, as
    SamplerPT's callers do; the CPU is an explicit choice."""
    import inspect

    params = inspect.signature(tspec.fit_spectral_clustering).parameters
    assert params["device"].default == "cuda"
