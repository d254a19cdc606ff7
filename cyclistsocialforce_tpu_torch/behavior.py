"""Rider control behavior: the GMM pole models, the host part that the
deterministic balancing rider reads (counterpart of the host half of
`cyclistsocialforce_tpu.behavior`; reference controlbehavior.py).

A pole model is a Gaussian mixture over closed-loop pole features,
conditioned on speed, behind a preprocessing pipeline (log-shift,
Yeo-Johnson, standard scaler). `BalancingRiderParams.create` reads one
thing of it: each component's mean pole features as a linear function of
speed (`PoleModel.component_mean_function_params`). Everything here is
numpy and runs once, at parameter construction; no step reads it.

The packaged models are the reference's fitted YAML files, kept here as
JSON twins (`data/balancingriderparams/*.json`, the same values): JSON is
in the standard library, so loading one needs no YAML parser.
`load_packaged_polemodel` takes the YAML name of the JAX API.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

# Predefined feature sets (reference controlbehavior.py:992-999).
PREDEFINED_FEATURE_SETS = {
    "ImRe5": (["p0_real", "p1_real", "p1_imag", "p2_real", "p2_imag"], ""),
    "ImRe5GivenV": (["v_mean", "p0_real", "p1_real", "p1_imag", "p2_real",
                     "p2_imag"], "v_mean"),
    "AngMag5": (["p0_real", "p1_mag", "p1_ang", "p2_mag", "p2_ang"], ""),
    "AngMag5GivenV": (["v_mean", "p0_real", "p1_mag", "p1_ang", "p2_mag",
                       "p2_ang"], "v_mean"),
    "Re1": (["p0_real"], ""),
    "Re1GivenV": (["v_mean", "p0_real"], "v_mean"),
}

DATA_DIR = os.path.join(os.path.dirname(__file__), "data",
                        "balancingriderparams")


@dataclass
class GMMData:
    """Parameters of a Gaussian mixture: means [K, F], covariances
    [K, F, F], weights [K] (reference GaussianMixture.from_parameters,
    controlbehavior.py:183-232)."""

    means: np.ndarray
    covariances: np.ndarray
    weights: np.ndarray

    def __post_init__(self):
        self.means = np.asarray(self.means, dtype=float)
        self.covariances = np.asarray(self.covariances, dtype=float)
        self.weights = np.asarray(self.weights, dtype=float).reshape(-1)
        k, f = self.means.shape
        if self.covariances.shape != (k, f, f):
            raise ValueError(
                f"covariances must be shaped [{k},{f},{f}], got "
                f"{self.covariances.shape}")
        if self.weights.size != k:
            raise ValueError(f"weights must be size {k}")

    @property
    def n_components(self):
        return self.means.shape[0]

    @property
    def n_features(self):
        return self.means.shape[1]


def conditional_gmm(gmm: GMMData, idx_given: int, x_given: float) -> GMMData:
    """The mixture conditioned on feature `idx_given` = `x_given`
    (reference ConditionalGaussianMixture._get_conditional_gmm,
    controlbehavior.py:478-530): per component the Gaussian conditional
    mean and covariance, the weights re-weighted by the given feature's
    marginal density (with the reference's zero-weight epsilon guard)."""
    f = gmm.n_features
    idx_rest = [i for i in range(f) if i != idx_given]

    mu_c, cov_c, pi_c = [], [], []
    for k in range(gmm.n_components):
        cov = gmm.covariances[k]
        mu = gmm.means[k]
        var_g = cov[idx_given, idx_given]
        cov_rg = cov[idx_rest, idx_given]
        d = x_given - mu[idx_given]
        mu_c.append(mu[idx_rest] + cov_rg / var_g * d)
        cov_c.append(cov[np.ix_(idx_rest, idx_rest)]
                     - np.outer(cov_rg, cov_rg) / var_g)
        pi_c.append(gmm.weights[k]
                    * np.exp(-0.5 * d * d / var_g) / np.sqrt(2 * np.pi * var_g))

    pi_c = np.asarray(pi_c)
    pi_c = pi_c / pi_c.sum()
    if np.any(pi_c == 0.0):
        pi_c[pi_c == 0.0] = np.finfo(float).eps * gmm.n_components
        pi_c = pi_c / pi_c.sum()
    return GMMData(np.asarray(mu_c), np.asarray(cov_c), pi_c)


def yeojohnson(x, lam):
    """Yeo-Johnson power transform, elementwise (broadcasting over lam)."""
    x = np.asarray(x, dtype=float)
    pos = x >= 0
    with np.errstate(all="ignore"):
        y_pos = np.where(np.abs(lam) < 1e-19, np.log1p(x),
                         (np.power(np.abs(x) + 1.0, lam) - 1.0)
                         / np.where(lam == 0, 1.0, lam))
        y_neg = np.where(np.abs(lam - 2.0) < 1e-19, -np.log1p(-x),
                         -(np.power(1.0 - np.minimum(x, 0.0), 2.0 - lam)
                           - 1.0) / np.where(lam == 2.0, 1.0, 2.0 - lam))
    return np.where(pos, y_pos, y_neg)


def yeojohnson_inverse(y, lam):
    """Inverse Yeo-Johnson; out-of-domain values map to NaN (the reference
    relies on sklearn returning non-finite values there and resamples,
    controlbehavior.py:1370-1395)."""
    y = np.asarray(y, dtype=float)
    pos = y >= 0
    with np.errstate(all="ignore"):
        base_p = lam * y + 1.0
        x_pos = np.where(np.abs(lam) < 1e-19, np.expm1(y),
                         np.power(np.where(base_p > 0, base_p, np.nan),
                                  1.0 / np.where(lam == 0, 1.0, lam)) - 1.0)
        base_n = -(2.0 - lam) * y + 1.0
        x_neg = np.where(np.abs(lam - 2.0) < 1e-19, 1.0 - np.exp(-y),
                         1.0 - np.power(
                             np.where(base_n > 0, base_n, np.nan),
                             1.0 / np.where(lam == 2.0, 1.0, 2.0 - lam)))
    return np.where(pos, x_pos, x_neg)


@dataclass
class Preprocessing:
    """Fitted preprocessing pipeline: optional log-shift on a feature
    subset, then Yeo-Johnson with optional standard scaling. Layout of the
    reference's export (controlbehavior.py:1993-2023): log `a`/`sign` over
    the log-transformed subset; `lambdas`/`mean`/`scale` per feature."""

    n_features: int
    lambdas: np.ndarray | None = None           # Yeo-Johnson lambdas [F]
    scaler_mean: np.ndarray | None = None        # StandardScaler mean [F]
    scaler_scale: np.ndarray | None = None       # StandardScaler scale [F]
    log_a: np.ndarray | None = None              # [n_log]
    log_sign: np.ndarray | None = None           # [n_log]
    log_features: np.ndarray | None = None       # int indices into features
    n_samples_seen: int = 0

    @property
    def has_log(self):
        return self.log_features is not None and self.log_features.size > 0

    def _expand(self, X, sparse_cols):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if sparse_cols is None:
            return X.copy(), None
        sparse_cols = np.asarray(sparse_cols).reshape(-1)
        full = np.zeros((X.shape[0], self.n_features))
        for i, j in enumerate(sparse_cols):
            full[:, j] = X[:, i]
        return full, sparse_cols

    def transform(self, X, sparse_column_indices=None):
        """Forward transform (reference PreprocessingPipeline.transform,
        controlbehavior.py:917-950), with the sparse-column fill that keeps
        absent log-features inside the log domain."""
        Xf, sparse = self._expand(X, sparse_column_indices)
        if self.has_log:
            if sparse is not None:
                for pos, i in enumerate(self.log_features):
                    if not np.any(sparse == i):
                        Xf[:, i] = self.log_sign[pos] * self.log_a[pos] * 2
            sub = Xf[:, self.log_features] * self.log_sign
            Xf[:, self.log_features] = np.log(sub - self.log_a)
        if self.lambdas is not None:
            Xf = yeojohnson(Xf, self.lambdas)
            if self.scaler_mean is not None:
                Xf = (Xf - self.scaler_mean) / self.scaler_scale
        if sparse is not None:
            Xf = Xf[:, sparse]
        return Xf

    def inverse_transform(self, X, sparse_column_indices=None):
        """Inverse transform (reference controlbehavior.py:953-982)."""
        Xf, sparse = self._expand(X, sparse_column_indices)
        if self.lambdas is not None:
            if self.scaler_mean is not None:
                Xf = Xf * self.scaler_scale + self.scaler_mean
            Xf = yeojohnson_inverse(Xf, self.lambdas)
        if self.has_log:
            Xf[:, self.log_features] = (
                np.exp(Xf[:, self.log_features]) + self.log_a) * self.log_sign
        if sparse is not None:
            Xf = Xf[:, sparse]
        return Xf


def pole_features_to_poles(feats, feature_names):
    """[.., F] pole features -> [.., P] complex poles, each complex pole
    followed by its conjugate (reference polefeaturetable_to_polearray,
    controlbehavior.py:64-112)."""
    feats = np.atleast_2d(np.asarray(feats, dtype=float))
    cols = {f: feats[:, i] for i, f in enumerate(feature_names)}
    poles = []
    for i in range(10):
        real, imag = cols.get(f"p{i}_real"), cols.get(f"p{i}_imag")
        mag, ang = cols.get(f"p{i}_mag"), cols.get(f"p{i}_ang")
        if real is None and mag is None:
            break
        p = np.zeros(feats.shape[0], dtype=complex)
        if real is not None:
            p = p + real
        if imag is not None:
            p = p + 1j * imag
        if mag is not None and ang is not None:
            p = p + mag * (np.cos(ang) + 1j * np.sin(ang))
        poles.append(p)
        if np.any(np.imag(p) != 0.0):
            poles.append(np.conjugate(p))
    return np.array(poles).T


@dataclass
class PoleModel:
    """A fitted (conditional) GMM over closed-loop pole features
    (reference PoleModel, controlbehavior.py:989-2137): loading, and the
    component means as linear functions of speed. Sampling, fitting,
    marginal densities and export are not ported (ROADMAP Queue 1 items 9
    and 12)."""

    feature_set: str
    gmm: GMMData
    preprocessing: Preprocessing
    metadata: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.feature_set not in PREDEFINED_FEATURE_SETS:
            raise ValueError(
                f"feature_set must be one of "
                f"{list(PREDEFINED_FEATURE_SETS)}, got {self.feature_set}")
        self.features, self.feature_cond = PREDEFINED_FEATURE_SETS[
            self.feature_set]
        self._linfit = None

    @property
    def idx_given(self):
        return (self.features.index(self.feature_cond)
                if self.feature_cond else None)

    @property
    def is_conditional(self):
        return self.feature_cond != ""

    @classmethod
    def from_dict(cls, data):
        """The model held by the parsed contents of one of the reference's
        parameter files (the schema of its export_to_yaml,
        controlbehavior.py:1987-2137)."""
        pp = data["preprocessing_pipeline"]
        gmd = data["gmm_data"]
        pre = Preprocessing(n_features=gmd["n_features"])
        if pp.get("power_transform", "none") != "none":
            pre.lambdas = np.asarray(
                pp["power_transform_params"]["lambdas"], dtype=float)
        if pp.get("normalize"):
            sc = pp["standard_scaler_params"]
            pre.scaler_mean = np.asarray(sc["mean"], dtype=float)
            pre.scaler_scale = np.asarray(sc["scale"], dtype=float)
            pre.n_samples_seen = int(sc.get("n_samples_seen", 0))
        if pp.get("log_transform"):
            lt = pp["log_transform_params"]
            pre.log_a = np.asarray(lt["a"], dtype=float).reshape(-1)
            pre.log_sign = np.asarray(lt["sign"], dtype=float).reshape(-1)
            pre.log_features = np.asarray(
                lt["log_transform_features"], dtype=int)
        gmm = GMMData(gmd["means"], gmd["covariances"], gmd["weights"])
        meta = {"presets": data.get("presets", {}),
                "scores": {k: gmd[k] for k in
                           ("scores_val", "scores_test", "n_samples_train",
                            "n_samples_test", "k_crossval") if k in gmd}}
        return cls(feature_set=data["presets"]["feature_set"], gmm=gmm,
                   preprocessing=pre, metadata=meta)

    def _transform_given(self, v):
        """Raw conditioning value(s) into model space (reference
        PoleModel.sample, controlbehavior.py:1352-1358)."""
        v = np.atleast_1d(np.asarray(v, dtype=float))
        tmp = np.zeros((v.size, self.gmm.n_features))
        tmp[:, self.idx_given] = v
        t = self.preprocessing.transform(
            tmp, sparse_column_indices=[self.idx_given])
        return t[:, 0]

    def _rest_indices(self):
        return [i for i in range(len(self.features))
                if i != self.idx_given] if self.is_conditional else list(
                    range(len(self.features)))

    def component_mean_features(self, v):
        """Per-component mean pole features at speed v, [K, F-1]
        (reference get_component_means, controlbehavior.py:1472-1540)."""
        vg = self._transform_given(v)[0]
        g = conditional_gmm(self.gmm, self.idx_given, vg)
        return self.preprocessing.inverse_transform(
            g.means, sparse_column_indices=self._rest_indices())

    def component_mean_function_params(self, v_grid=None):
        """Linear-in-speed least-squares fit of the component mean
        features, [K, F-1, 2] with [..., 0] the intercept and [..., 1] the
        slope (reference get_component_mean_function,
        controlbehavior.py:1601-1650: LinearRegression over
        linspace(1.5, 5.5, 250))."""
        if not self.is_conditional:
            k = self.gmm.n_components
            means = self.preprocessing.inverse_transform(self.gmm.means)
            return np.stack([np.c_[means[i], np.zeros(means.shape[1])]
                             for i in range(k)], axis=0)
        if v_grid is None:
            v_grid = np.linspace(1.5, 5.5, 250)
        means = np.stack([self.component_mean_features(v)
                          for v in v_grid], axis=2)   # [K, F-1, n_v]
        X = np.c_[np.ones_like(v_grid), v_grid]       # [n_v, 2]
        out = np.empty(means.shape[:2] + (2,))
        for i in range(means.shape[0]):
            coef, *_ = np.linalg.lstsq(X, means[i].T, rcond=None)
            out[i] = coef.T                            # [F-1, 2]
        return out

    def mean_poles(self, v, component=0):
        """Mean pole locations of one component at speed v, complex, in
        the reference's ordering (update_control_params, reference
        parameters.py:1397-1411): the linear-in-speed fit of the component
        means, as the reference's runtime evaluates it."""
        if self._linfit is None:
            self._linfit = self.component_mean_function_params()
        feats = (self._linfit[component, :, 0]
                 + self._linfit[component, :, 1] * float(v))
        names = [self.features[i] for i in self._rest_indices()]
        return pole_features_to_poles(feats[None], names)[0]


def packaged_polemodel_path(filename) -> str:
    """The path of the packaged twin of pole-model file `filename`, given
    by its YAML name (the JAX API's) or its JSON name."""
    stem, ext = os.path.splitext(os.path.basename(filename))
    path = os.path.join(DATA_DIR, stem + ".json")
    if ext not in (".yaml", ".yml", ".json") or not os.path.exists(path):
        avail = sorted(f[:-len(".json")] + ".yaml"
                       for f in os.listdir(DATA_DIR) if f.endswith(".json"))
        raise FileNotFoundError(
            f"Couldn't find pole model {filename} in {DATA_DIR}. "
            f"Available models: {avail}")
    return path


def load_packaged_polemodel(filename) -> PoleModel:
    """Load one of the packaged pole models (the reference's fitted
    models), named as the JAX package names it, e.g.
    "BR1_ImRe5GivenV_pole-model-params.yaml"."""
    with open(packaged_polemodel_path(filename)) as f:
        return PoleModel.from_dict(json.load(f))


__all__ = ["DATA_DIR", "GMMData", "PREDEFINED_FEATURE_SETS", "PoleModel",
           "Preprocessing", "conditional_gmm", "load_packaged_polemodel",
           "packaged_polemodel_path", "pole_features_to_poles",
           "yeojohnson", "yeojohnson_inverse"]
