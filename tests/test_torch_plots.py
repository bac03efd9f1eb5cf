"""The port's R analysis layer against the JAX package's: plots.py
(bcm3_tpu_torch/plots.py, under the Agg backend) and the executable model
of the R loading contract (bcm3_tpu_torch/io/hdf5r_compat.py).

- `weighted_kde`, `marginal_density` (its drawn curves), `bivariate_density`
  (its image) and `_cov_ellipse` equal the JAX package's on the same
  inputs and priors; every figure function draws to a PNG.
- `bcm3_load_results`, `variable_summary`, `marginal_likelihood` and
  `load_netcdf_bundler_data` of both packages agree on an output.nc and a
  sampler_adaptation.nc that the port's CLI writes from the in-repo banana
  fixture (tests/test_r_contract.py runs the same contract off the
  reference's example files).
"""

import os
import shutil

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from bcm3_tpu import plots as jax_plots  # noqa: E402
from bcm3_tpu.io import hdf5r_compat as jax_rload  # noqa: E402
from bcm3_tpu.model.prior import Prior as JaxPrior  # noqa: E402
from bcm3_tpu_torch import plots  # noqa: E402
from bcm3_tpu_torch.io import hdf5r_compat as rload  # noqa: E402
from bcm3_tpu_torch.io.bundler import load_bundle, write_adaptation_dump  # noqa: E402
from bcm3_tpu_torch.model.prior import Prior  # noqa: E402

BANANA = os.path.join(os.path.dirname(__file__), "fixtures", "examples", "banana")


def _priors(tmp_path):
    """Both packages' priors over one file: a uniform, a normal, a gamma
    and a beta variable."""
    p = tmp_path / "prior.xml"
    p.write_text(
        "<prior>"
        '<variable name="a" distribution="uniform" lower="0" upper="1"/>'
        '<variable name="b" distribution="normal" mu="0.5" sigma="0.2"/>'
        '<variable name="c" distribution="gamma" k="2" theta="0.3"/>'
        '<variable name="d" distribution="beta" a="2" b="3"/>'
        "</prior>")
    return Prior.from_xml(str(p)), JaxPrior.from_xml(str(p))


def _results(S=400, T=2, D=4, seed=1):
    rng = np.random.default_rng(seed)
    samples = rng.uniform(0.2, 0.8, size=(S, T, D))
    return {
        "samples": samples,
        "weights": rng.uniform(0.5, 1.5, size=S),
        "log_prior": np.zeros((S, T)),
        "log_likelihood": np.zeros((S, T)),
        "variables": ["a", "b", "c", "d"][:D],
        "variable_transform": np.zeros(D, dtype=np.int32),
    }


@pytest.mark.parametrize("bounds", [(np.nan, np.nan), (0.0, np.nan), (0.0, 1.0)])
def test_weighted_kde_matches_jax(bounds):
    rng = np.random.default_rng(0)
    s = rng.beta(2.0, 5.0, size=500)
    w = rng.uniform(0.1, 1.0, size=500)
    grid = np.linspace(0.0, 1.0, 301)
    got = plots.weighted_kde(s, w, grid, *bounds, adjust=1.3)
    np.testing.assert_array_equal(got, jax_plots.weighted_kde(s, w, grid, *bounds, adjust=1.3))
    np.testing.assert_allclose(np.trapezoid(got, grid), 1.0, atol=0.05)


def test_marginal_and_bivariate_densities_match_jax(tmp_path):
    prior, jprior = _priors(tmp_path)
    res = _results()
    for v in range(4):
        ax, jax_ax = plots.marginal_density(res, prior, v), jax_plots.marginal_density(
            res, jprior, v)
        assert ax.get_title() == jax_ax.get_title() == res["variables"][v]
        for line, jline in zip(ax.get_lines(), jax_ax.get_lines(), strict=True):
            np.testing.assert_allclose(line.get_xydata(), jline.get_xydata(), rtol=1e-12)
    ax = plots.bivariate_density(res, prior, 0, 3, gridsize=12)
    jax_ax = jax_plots.bivariate_density(res, jprior, 0, 3, gridsize=12)
    np.testing.assert_array_equal(ax.get_images()[0].get_array(),
                                  jax_ax.get_images()[0].get_array())
    assert ax.get_xlabel() == "a" and ax.get_ylabel() == "d"
    plt.close("all")


def test_cov_ellipse_matches_jax():
    from scipy import stats

    mean = np.array([1.0, -2.0])
    cov = np.array([[2.0, 0.6], [0.6, 0.5]])
    pts = plots._cov_ellipse(mean, cov, level=0.6)
    np.testing.assert_array_equal(pts, jax_plots._cov_ellipse(mean, cov, level=0.6))
    d = pts - mean
    m = np.einsum("ni,ij,nj->n", d, np.linalg.inv(cov), d)
    np.testing.assert_allclose(m, stats.chi2.ppf(0.6, 2), rtol=1e-4)


def test_figure_functions_draw(tmp_path):
    """Every figure function of the port draws: traces, densities, the
    prior alone, the posterior predictive under the four error models, the
    line plot and the adaptation ellipses (from the port's bundler)."""
    prior, _ = _priors(tmp_path)
    res = _results()
    plots.plot_all_traces(res, str(tmp_path / "traces.png"))
    plots.plot_all_densities(res, prior, str(tmp_path / "dens.png"))
    assert (tmp_path / "traces.png").stat().st_size > 0
    assert (tmp_path / "dens.png").stat().st_size > 0
    assert plots.trace_plot(res, 1).get_title() == "b"
    assert plots.plot_variable_prior(prior, 2).get_title() == "c"
    rng = np.random.default_rng(4)
    for model in ("normal", "truncated_normal", "t", "truncated_t"):
        plots.ppd_barplot(rng.normal(0.5, 0.05, size=(100, 3)), np.array([0.45, 0.52, 0.55]),
                          ["c1", "c2", "c3"], sd_samples=0.1, error_model=model)
    draws = plots._predictive_draws(rng, np.full(200, 0.5), 0.3, "truncated_t", 10)
    assert draws.min() >= 0.0 and draws.max() <= 1.0
    x = np.linspace(0, 10, 25)
    plots.ppd_lineplot(x, np.sin(x), x, np.sin(x)[None, :] + rng.normal(0, 0.1, (80, 25)))

    class StubGMM:
        num_components = 2
        weights = np.array([0.6, 0.4])
        means = np.array([[0.3, 0.3], [0.7, 0.7]])
        covariances = np.array([np.diag([0.01, 0.02]), [[0.02, 0.005], [0.005, 0.01]]])

    fn = str(tmp_path / "sampler_adaptation.nc")
    write_adaptation_dump(fn, 1, [(np.array([0, 1]), StubGMM())])
    ax = plots.adaptation_ellipse_plot(res, load_bundle(fn), "adapt1", "block1", 0, 1)
    assert len(ax.get_lines()) == 3  # the samples and one ellipse a component
    with pytest.raises(ValueError):
        plots.adaptation_ellipse_plot(res, load_bundle(fn), "adapt1", "block1", 0, 2)
    plt.close("all")


@pytest.fixture(scope="module")
def banana_run(tmp_path_factory):
    """The port's CLI on the banana fixture (80 samples thinned by 2, 4
    chains, one adaptation with its dump), on the CPU in float64."""
    from bcm3_tpu_torch import cli

    base = tmp_path_factory.mktemp("banana")
    for fn in ("prior.xml", "likelihood.xml"):
        shutil.copy(os.path.join(BANANA, fn), base / fn)
    cfg = base / "config.txt"
    cfg.write_text(
        "[sampler]\nnum_samples=80\nuse_every_nth=2\nrngseed=123\n\n"
        "[ptmhsampler]\nnum_chains=4\nadapt_proposal_samples=40\nadapt_proposal_times=1\n"
        "output_proposal_adaptation=true\n\n"
        f"[output]\nfolder={base}/out\n")
    assert cli.main(["-c", str(cfg), "--prior", str(base / "prior.xml"), "--likelihood",
                     str(base / "likelihood.xml"), "--device", "cpu", "--dtype",
                     "float64"]) == 0
    return str(base)


def _assert_same(a, b, path="model"):
    """Nested dicts, lists and arrays equal, NaN where NaN."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) and not (a and isinstance(a[0], (int, float))):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (str, type(None))):
        assert a == b, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_load_results_matches_jax(banana_run):
    """bcm3.load.results of both packages on the port's output: the same
    model, in hdf5r's [variable, temperature, sample] view."""
    model = rload.bcm3_load_results(banana_run, "out")
    _assert_same(model, jax_rload.bcm3_load_results(banana_run, "out"))
    post = model["posterior"]
    assert post["samples"].shape == (2, 4, 80)
    assert post["lprior"].shape == post["llikelihood"].shape == (4, 80)
    assert post["temperatures"][0] == 0.0 and post["temperatures"][-1] == 1.0
    assert np.isfinite(post["lposterior"][-1]).all()
    assert set(model["sampler_adaptation"]) == {"adapt0", "adapt1"}
    _assert_same(rload.load_netcdf_bundler_data(os.path.join(banana_run, "out",
                                                             "sampler_adaptation.nc")),
                 model["sampler_adaptation"])


def test_variable_summary_and_marginal_likelihood_match_jax(banana_run):
    model = rload.bcm3_load_results(banana_run, "out")
    jmodel = jax_rload.bcm3_load_results(banana_run, "out")
    summary = rload.variable_summary(model)
    _assert_same(summary, jax_rload.variable_summary(jmodel))
    assert summary["row_names"] == ["x1", "x2"]
    assert all(np.isfinite(summary[k]).all() for k in ("mean", "sd", "q025", "q975"))
    ml = rload.marginal_likelihood(model)
    assert np.isfinite(ml) and ml == jax_rload.marginal_likelihood(jmodel)
    x = model["posterior"]["samples"][0, -1]
    for stat, kw in (("median", {}), ("quantile", {"q": 0.3}), ("autocorrelation", {"lag": 2}),
                     ("decorr_lag", {}), ("ess", {})):
        assert rload.variable_statistic(x, stat, **kw) == jax_rload.variable_statistic(
            x, stat, **kw)
