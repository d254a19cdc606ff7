"""PyTorch port: the pole models (`behavior`) that the deterministic
balancing rider reads, held to the JAX package.

The packaged JSON twins hold exactly what `yaml.safe_load` reads from the
JAX package's YAML files; every packaged model's preprocessing
(forward and inverse), conditional mixture, component mean features,
linear mean functions and mean poles against the JAX package at 1e-12;
the loader takes the JAX API's YAML names and refuses unknown ones.
"""

import json
import os
import types

import numpy as np
import pytest

from cyclistsocialforce_tpu_torch import behavior as TB

FILES = ("BR0_ImRe5GivenV_pole-model-params.yaml",
         "BR1_ImRe5GivenV_pole-model-params.yaml",
         "PP0_Re1GivenV_pole-model-params.yaml")
TOL = 1e-12


@pytest.fixture
def jx():
    """The JAX package's behavior module used as the reference."""
    pytest.importorskip("jax")
    from cyclistsocialforce_tpu import behavior as JB

    return types.SimpleNamespace(JB=JB)


def assert_rel(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", FILES)
def test_json_twins_hold_the_yaml_files(jx, name):
    """Each twin equals `yaml.safe_load` of the JAX package's file, value
    for value; nothing else lies in the data directory."""
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(jx.JB.DATA_DIR, name)) as f:
        want = yaml.safe_load(f)
    with open(TB.packaged_polemodel_path(name)) as f:
        assert json.load(f) == want
    assert sorted(os.listdir(TB.DATA_DIR)) == sorted(
        f[:-len(".yaml")] + ".json" for f in FILES)


@pytest.mark.parametrize("name", FILES)
def test_pole_model_matches_jax(jx, name):
    got = TB.load_packaged_polemodel(name)
    want = jx.JB.load_packaged_polemodel(name)
    assert got.feature_set == want.feature_set
    assert got.features == want.features and got.idx_given == want.idx_given
    assert got.metadata == want.metadata
    for f in ("means", "covariances", "weights"):
        np.testing.assert_array_equal(getattr(got.gmm, f),
                                      getattr(want.gmm, f))
    assert_rel(got.component_mean_function_params(),
               want.component_mean_function_params())
    for v in (1.5, 3.7, 5.5):
        assert_rel(got.component_mean_features(v),
                   want.component_mean_features(v))
        assert_rel(got._transform_given(v), want._transform_given(v))
        for k in range(got.gmm.n_components):
            assert_rel(got.mean_poles(v, k), want.mean_poles(v, k))


@pytest.mark.parametrize("name", FILES)
def test_preprocessing_and_conditioning_match_jax(jx, name):
    """The pipeline forward and inverse on seeded data (full and sparse
    columns), Yeo-Johnson and its inverse, and the conditional mixture."""
    got = TB.load_packaged_polemodel(name)
    want = jx.JB.load_packaged_polemodel(name)
    f = got.gmm.n_features
    rng = np.random.default_rng(f)
    X = rng.normal(size=(16, f))
    X[:, 0] = rng.uniform(1.0, 6.0, 16)
    pre = got.preprocessing
    if pre.has_log:          # inside the log-shift's domain
        for k, j in enumerate(pre.log_features):
            X[:, j] = pre.log_sign[k] * (pre.log_a[k]
                                         + rng.uniform(0.1, 2.0, 16))
    Xt = got.preprocessing.transform(X)
    assert np.isfinite(Xt).all()
    assert_rel(Xt, want.preprocessing.transform(X))
    assert_rel(got.preprocessing.inverse_transform(Xt),
               want.preprocessing.inverse_transform(Xt))
    rest = got._rest_indices()
    assert_rel(got.preprocessing.inverse_transform(Xt[:, rest], rest),
               want.preprocessing.inverse_transform(Xt[:, rest], rest))
    lam = rng.uniform(-1.0, 3.0, f)
    assert_rel(TB.yeojohnson(X, lam), jx.JB.yeojohnson(X, lam))
    Y = TB.yeojohnson(X, lam)
    assert_rel(TB.yeojohnson_inverse(Y, lam),
               jx.JB.yeojohnson_inverse(Y, lam))
    g = TB.conditional_gmm(got.gmm, got.idx_given, 0.3)
    w = jx.JB.conditional_gmm(want.gmm, want.idx_given, 0.3)
    for a in ("means", "covariances", "weights"):
        assert_rel(getattr(g, a), getattr(w, a))


def test_loader_names():
    """The YAML name of the JAX API and the JSON name load the same
    model; an unknown name lists the packaged ones."""
    a = TB.load_packaged_polemodel(FILES[1])
    b = TB.load_packaged_polemodel(FILES[1][:-len(".yaml")] + ".json")
    np.testing.assert_array_equal(a.component_mean_function_params(),
                                  b.component_mean_function_params())
    with pytest.raises(FileNotFoundError, match="BR1_ImRe5GivenV"):
        TB.load_packaged_polemodel("nope.yaml")
