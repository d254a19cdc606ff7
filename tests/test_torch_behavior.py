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


def assert_models_equal(a, b, tol=0.0):
    """Two pole models (either package's) with the same feature set,
    mixture and preprocessing."""
    assert a.feature_set == b.feature_set
    for f in ("means", "covariances", "weights"):
        assert_rel(getattr(a.gmm, f), getattr(b.gmm, f), tol)
    pa, pb = a.preprocessing, b.preprocessing
    for f in ("lambdas", "scaler_mean", "scaler_scale", "log_a", "log_sign",
              "log_features"):
        va, vb = getattr(pa, f), getattr(pb, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert_rel(va, vb, tol)
    assert pa.n_samples_seen == pb.n_samples_seen


@pytest.mark.parametrize("name", FILES)
def test_sampling_equals_jax(jx, name):
    """GMMData.sample, sample_pole_features and sample_poles with the same
    numpy generator draw what JAX's draw (numpy on both sides)."""
    got = TB.load_packaged_polemodel(name)
    want = jx.JB.load_packaged_polemodel(name)
    a, la = got.gmm.sample(200, np.random.default_rng(4))
    b, lb = want.gmm.sample(200, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    for v in (2.0, 4.5):
        a, la = got.sample_pole_features(64, v=v,
                                         rng=np.random.default_rng(9))
        b, lb = want.sample_pole_features(64, v=v,
                                          rng=np.random.default_rng(9))
        assert_rel(a, b)
        np.testing.assert_array_equal(la, lb)
        a, la = got.sample_poles(32, X_given=v, rng=np.random.default_rng(2))
        b, lb = want.sample_poles(32, X_given=v,
                                  rng=np.random.default_rng(2))
        assert_rel(a.real, b.real)
        assert_rel(a.imag, b.imag)
        np.testing.assert_array_equal(la, lb)
        assert (a.real <= 0).all()
    with pytest.raises(ValueError, match="pass the speed"):
        got.sample_pole_features(2)


def test_variance_scale_and_marginals_equal_jax(jx):
    got = TB.load_packaged_polemodel(FILES[0]).gmm
    want = jx.JB.load_packaged_polemodel(FILES[0]).gmm
    a, b = got.scale_variance(2.5), want.scale_variance(2.5)
    assert_rel(a.covariances, b.covariances)
    with pytest.raises(ValueError):
        got.scale_variance(0.0)
    x = np.linspace(-3, 3, 41)
    for idx in (0, 3):
        for fa, fb in ((got.marginal_pdf_1d(x, idx),
                        want.marginal_pdf_1d(x, idx)),
                       (got.marginal_pdf_1d_range((-2, 2), idx, 50),
                        want.marginal_pdf_1d_range((-2, 2), idx, 50))):
            assert_rel(fa[0], fb[0])
            assert_rel(fa[1], fb[1])
    pa, da = got.marginal_pdf_2d((-2, 2), (-1, 3), 1, 4, n_samples=30)
    pb, db = want.marginal_pdf_2d((-2, 2), (-1, 3), 1, 4, n_samples=30)
    assert_rel(pa, pb)
    assert_rel(da, db)


def test_preprocessing_fit_equals_jax(jx):
    """Preprocessing.fit (log shift on the real-part features, scipy's
    Yeo-Johnson MLE, the standard scaler) on features sampled from a
    packaged model: JAX's lambdas, log shift and scaler."""
    pm = TB.load_packaged_polemodel(FILES[1])
    rng = np.random.default_rng(1)
    v = np.linspace(1.5, 5.5, 80)
    X = np.array([np.r_[vi, pm.sample_pole_features(1, v=vi, rng=rng)[0][0]]
                  for vi in v])
    a = TB.Preprocessing(n_features=X.shape[1])
    b = jx.JB.Preprocessing(n_features=X.shape[1])
    ya = a.fit(X, pm.features)
    yb = b.fit(X, pm.features)
    assert_rel(ya, yb)
    for f in ("lambdas", "scaler_mean", "scaler_scale", "log_a", "log_sign",
              "log_features"):
        assert_rel(getattr(a, f), getattr(b, f))
    assert a.n_samples_seen == b.n_samples_seen == 80


def test_yaml_round_trip_with_jax(jx, tmp_path):
    """The port exports and JAX imports, JAX exports and the port imports,
    and the packaged YAML files import equal to the port's JSON twins."""
    pytest.importorskip("yaml")
    for name in FILES:
        twin = TB.load_packaged_polemodel(name)
        got = TB.PoleModel.import_from_yaml(
            os.path.join(jx.JB.DATA_DIR, name))
        assert_models_equal(got, twin)
        assert got.metadata == twin.metadata
        port_file, jax_file = tmp_path / "port.yaml", tmp_path / "jax.yaml"
        twin.export_to_yaml(port_file)
        assert_models_equal(jx.JB.PoleModel.import_from_yaml(port_file),
                            twin)
        jx.JB.load_packaged_polemodel(name).export_to_yaml(jax_file)
        back = TB.PoleModel.import_from_yaml(jax_file)
        assert_models_equal(back, twin)
        assert_rel(back.component_mean_function_params(),
                   twin.component_mean_function_params())


def test_fit_pole_model_equals_jax(jx):
    """fit_pole_model at a small size (60 samples of ImRe5GivenV features
    drawn from BR1, k = 1-2, full and diag, 3 folds, 4 restarts) selects
    JAX's hyperparameters, its mixture and preprocessing."""
    pm = TB.load_packaged_polemodel(FILES[1])
    rng = np.random.default_rng(3)
    v = np.linspace(1.5, 5.5, 60)
    X = np.array([np.r_[vi, pm.sample_pole_features(1, v=vi, rng=rng)[0][0]]
                  for vi in v])
    kw = dict(range_components=(1, 3), covariance_types=("full", "diag"),
              k_crossval=3, n_init=4, seed=1)
    got = TB.fit_pole_model(X, "ImRe5GivenV", **kw, device="cpu")
    want = jx.JB.fit_pole_model(X, "ImRe5GivenV", **kw)
    assert got.metadata["presets"] == want.metadata["presets"]
    assert_models_equal(got, want, 1e-8)
    for key in ("scores_val", "scores_test"):
        for m in ("NLL", "BIC", "AIC"):
            np.testing.assert_allclose(got.metadata["scores"][key][m],
                                       want.metadata["scores"][key][m],
                                       rtol=1e-9)
    assert_rel(got.mean_poles(3.0, 0).real, want.mean_poles(3.0, 0).real,
               1e-7)
    with pytest.raises(ValueError, match="expects 6 columns"):
        TB.fit_pole_model(X[:, :3], "ImRe5GivenV", device="cpu")


def test_combine_outliers_equals_jax(jx):
    """Per-model flags over ids in different orders, ids missing from a
    model (not flagged by it), and plain flag arrays."""
    cases = [
        {"a": (np.array([3, 1, 2]), np.array([True, False, False])),
         "b": (np.array([1, 2, 5]), np.array([False, True, False]))},
        {"a": np.array([False, True, False, False]),
         "b": np.array([True, False, False, False])},
        {"only": (np.array([4, 7]), np.array([False, True]))},
    ]
    for case in cases:
        ids, flags = TB.combine_outliers(case)
        jids, jflags = jx.JB.combine_outliers(case)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(flags, jflags)
    ids, flags = TB.combine_outliers(cases[0])
    assert dict(zip(ids.tolist(), flags.tolist())) == {
        1: False, 2: True, 3: True, 5: False}
    with pytest.raises(ValueError, match="must align"):
        TB.combine_outliers({"x": (np.arange(3), np.zeros(2, bool))})
    # one model with unsorted ids: both packages index past the end (a
    # JAX-side fault kept as it is, ROADMAP Queue 3.17)
    unsorted = {"only": (np.array([7, 4]), np.array([False, True]))}
    for fn in (TB.combine_outliers, jx.JB.combine_outliers):
        with pytest.raises(IndexError):
            fn(unsorted)


def test_convert_polemodel_from_jax(jx):
    """`convert.polemodel_from_jax` and `gmm_from_jax`: the same model,
    its Preprocessing copied (no array shared with the JAX model)."""
    from cyclistsocialforce_tpu_torch import convert

    for name in FILES:
        want = jx.JB.load_packaged_polemodel(name)
        got = convert.polemodel_from_jax(want)
        assert isinstance(got, TB.PoleModel)
        assert_models_equal(got, want)
        assert got.metadata == want.metadata
        assert got.preprocessing.lambdas is not want.preprocessing.lambdas
        assert_rel(got.component_mean_function_params(),
                   want.component_mean_function_params())
        g = convert.gmm_from_jax(want.gmm)
        assert isinstance(g, TB.GMMData)
        assert_rel(g.means, want.gmm.means)
