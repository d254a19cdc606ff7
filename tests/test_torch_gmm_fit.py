"""PyTorch port: Gaussian-mixture fitting (`gmm_fit.py`) held to the JAX
package's `gmm_fit` on the same numpy data (float64 on the CPU): the
k-means++ centres of every restart bit for bit (both draw JAX's streams),
every restart's final NLL within 1e-10 relative, the selected restart's
means, covariances and weights within 1e-8 and its NLL, BIC and AIC
within 1e-10 relative for the four covariance types, the scores, and
`fit_optimize`'s selected hyperparameters. Where two restarts of one fit
tie within rounding (the same mixture with its components in another
order) the packages may pick either: the test then holds the tie, the
NLL and the mixture up to the order of its components. The card's fit is
held to the CPU's in a `cuda`-marked test that skips here.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import gmm_fit as G  # noqa: E402
from cyclistsocialforce_tpu_torch.behavior import GMMData  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import random as R  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
N_INIT, N_ITER = 4, 30
PARAM_TOL, SCORE_RTOL = 1e-8, 1e-10


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from cyclistsocialforce_tpu import gmm_fit

    return types.SimpleNamespace(jax=jax, G=gmm_fit)


def data(seed=0, n=120, f=3):
    """Two clusters of n points in f features, numpy seeded."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 1.0, (n // 2, f))
    b = rng.normal(3.0, 0.6, (n - n // 2, f)) * np.linspace(1, 2, f)
    return np.concatenate([a, b])


def jax_restarts(jx, X, k, cov_type, seed):
    """JAX's per-restart (means, cov, weights, nll) of fit_gmm's batch."""
    import jax.numpy as jnp

    keys = jx.jax.random.split(jx.jax.random.PRNGKey(seed), N_INIT)
    out = jx.jax.vmap(lambda kk: jx.G._fit_single(
        kk, jnp.asarray(X), k, cov_type, N_ITER))(keys)
    return [np.asarray(a) for a in out]


def same_up_to_order(a: GMMData, b: GMMData, tol):
    """The two mixtures equal with their components in some order."""
    order = [int(np.argmin(np.abs(b.means - m).sum(axis=1)))
             for m in a.means]
    assert sorted(order) == list(range(a.n_components))
    np.testing.assert_allclose(a.means, b.means[order], rtol=0, atol=tol)
    np.testing.assert_allclose(a.covariances, b.covariances[order], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(a.weights, b.weights[order], rtol=0, atol=tol)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**32 + 3])
def test_kmeanspp_centres_equal_jax(jx, seed):
    import jax.numpy as jnp

    X = data(seed % 97)
    keys = jx.jax.random.split(jx.jax.random.PRNGKey(seed), 6)
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    for k in (1, 2, 3, 4):
        want = jx.jax.vmap(lambda kk: jx.G._kmeanspp_init(
            kk, jnp.asarray(X), k))(keys)
        got = G._kmeanspp_init(tkeys, torch.from_numpy(X), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cov_type", G.COVARIANCE_TYPES)
def test_fit_gmm_equals_jax(jx, cov_type):
    """Every restart's NLL, the selected restart and its mixture and
    scores, for k = 1..4 and two seeds."""
    X = data(3)
    for seed in (0, 5):
        for k in (1, 2, 3, 4):
            keys = R.split(R.key(seed, DEV), N_INIT)
            nll = G._fit_batch(keys, torch.from_numpy(X), k, cov_type,
                               N_ITER)[3].numpy()
            jnll = jax_restarts(jx, X, k, cov_type, seed)[3]
            np.testing.assert_allclose(nll, jnll, rtol=SCORE_RTOL)
            got, scores = G.fit_gmm(X, k, cov_type, n_init=N_INIT,
                                    n_iter=N_ITER, seed=seed, device=DEV)
            want, jscores = jx.G.fit_gmm(X, k, cov_type, n_init=N_INIT,
                                         n_iter=N_ITER, seed=seed)
            for key in ("NLL", "BIC", "AIC"):
                np.testing.assert_allclose(scores[key], jscores[key],
                                           rtol=SCORE_RTOL)
            if int(np.argmin(nll)) == int(np.argmin(jnll)):
                np.testing.assert_allclose(got.means, want.means, rtol=0,
                                           atol=PARAM_TOL)
                np.testing.assert_allclose(got.covariances,
                                           want.covariances, rtol=0,
                                           atol=PARAM_TOL)
                np.testing.assert_allclose(got.weights, want.weights,
                                           rtol=0, atol=PARAM_TOL)
            else:
                # a tie within rounding between two restarts that found
                # the same mixture: the NLLs above agree, and so does the
                # mixture, in another component order
                a, b = int(np.argmin(nll)), int(np.argmin(jnll))
                assert abs(jnll[a] - jnll[b]) <= 1e-12 * abs(jnll[b])
                same_up_to_order(got, want, PARAM_TOL)


def test_scores_equal_jax(jx):
    """score_nll, score_gmm, score_conditional_gmm and n_parameters."""
    from cyclistsocialforce_tpu.behavior import GMMData as JGMMData

    X = data(4, f=4)
    gmm, _ = G.fit_gmm(X, 3, "full", n_init=N_INIT, n_iter=N_ITER,
                       device=DEV)
    jgmm = JGMMData(gmm.means, gmm.covariances, gmm.weights)
    np.testing.assert_allclose(G.score_nll(gmm, X, DEV),
                               jx.G.score_nll(jgmm, X), rtol=SCORE_RTOL)
    for ct in G.COVARIANCE_TYPES:
        a = G.score_gmm(gmm, X, ct, DEV)
        b = jx.G.score_gmm(jgmm, X, ct)
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=SCORE_RTOL)
        for k in (1, 4):
            for f in (1, 6):
                assert G.n_parameters(k, f, ct) == jx.G.n_parameters(k, f,
                                                                     ct)
    a = G.score_conditional_gmm(gmm, X[:12], 0, "full", DEV)
    b = jx.G.score_conditional_gmm(jgmm, X[:12], 0, "full")
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=SCORE_RTOL)


def test_fit_optimize_selects_as_jax(jx):
    X = data(6, n=90)
    kw = dict(range_components=(1, 4), covariance_types=("full", "diag"),
              k_crossval=3, n_init=N_INIT, n_iter=N_ITER, seed=2)
    gmm, info = G.fit_optimize(X, **kw, device=DEV)
    jgmm, jinfo = jx.G.fit_optimize(X, **kw)
    assert info["hyperparameters"] == jinfo["hyperparameters"]
    assert len(info["gridsearch"]) == len(jinfo["gridsearch"]) == 6
    for r, jr in zip(info["gridsearch"], jinfo["gridsearch"]):
        assert (r["cov_type"], r["n_components"]) == (jr["cov_type"],
                                                     jr["n_components"])
        for key in ("NLL", "BIC", "AIC"):
            np.testing.assert_allclose(r[key], jr[key], rtol=1e-9)
    for key in ("NLL", "BIC", "AIC"):
        np.testing.assert_allclose(info["scores_train"][key],
                                   jinfo["scores_train"][key],
                                   rtol=SCORE_RTOL)
    same_up_to_order(gmm, jgmm, PARAM_TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fit_gmm_matches_cpu(cuda_device):
    """The restart batch on the card (float64) selects the CPU's restart
    and mixture (1e-8) for the four covariance types."""
    X = data(3)
    for ct in G.COVARIANCE_TYPES:
        got, s = G.fit_gmm(X, 3, ct, n_init=16, n_iter=60, seed=1,
                           device=cuda_device)
        want, w = G.fit_gmm(X, 3, ct, n_init=16, n_iter=60, seed=1,
                            device=DEV)
        np.testing.assert_allclose(s["NLL"], w["NLL"], rtol=SCORE_RTOL)
        same_up_to_order(got, want, PARAM_TOL)
