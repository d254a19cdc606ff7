"""Rider control behavior: the GMM pole models, the host part that the
deterministic balancing rider reads (counterpart of the host half of
`cyclistsocialforce_tpu.behavior`; reference controlbehavior.py).

A pole model is a Gaussian mixture over closed-loop pole features,
conditioned on speed, behind a preprocessing pipeline (log-shift,
Yeo-Johnson, standard scaler). `BalancingRiderParams.create` reads each
component's mean pole features as a linear function of speed
(`PoleModel.component_mean_function_params`): numpy, once, at parameter
construction. The stochastic balancing rider samples its pole features
in the step from `PoleModelRT` (torch, batched over riders, the JAX
package's draws from the same keys).

The host side also samples pole features and poles (numpy's generators,
the JAX package's draws), fits the preprocessing and, through
`gmm_fit`, the mixture (`fit_pole_model`), and reads and writes the
reference's YAML files (PyYAML, imported where it is used).

The packaged models are the reference's fitted YAML files, kept here as
JSON twins (`data/balancingriderparams/*.json`, the same values): JSON is
in the standard library, so loading one needs no YAML parser.
`load_packaged_polemodel` takes the YAML name of the JAX API.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from datetime import datetime

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.ops import random as rnd

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

    def sample(self, n_samples, rng):
        """Draw samples; returns (samples [n, F], component labels [n])."""
        labels = rng.choice(self.n_components, size=n_samples,
                            p=self.weights / self.weights.sum())
        out = np.empty((n_samples, self.n_features))
        for k in range(self.n_components):
            m = labels == k
            if np.any(m):
                out[m] = rng.multivariate_normal(
                    self.means[k], self.covariances[k], size=int(m.sum()))
        return out, labels

    def scale_variance(self, factor):
        """New GMMData with every component's covariance scaled by
        `factor` (the reference's variance_scale: cov -> S cov S^T with
        S = sqrt(factor) I, i.e. factor * cov;
        controlbehavior.py:246-254)."""
        if factor <= 0:
            raise ValueError("variance scale factor must be positive")
        return GMMData(means=self.means,
                       covariances=self.covariances * float(factor),
                       weights=self.weights)

    def marginal_pdf_1d(self, x, idx):
        """Marginal density of feature `idx` at locations `x`
        (reference eval_1d_marginal_pdf_samples,
        controlbehavior.py:280-307: the marginal of a GMM is the 1D
        mixture of the per-component marginals). Vectorized over
        components instead of a per-component scipy loop.

        Returns (x flattened, densities)."""
        x = np.asarray(x, dtype=float).reshape(-1)
        mu = self.means[:, idx]                      # [K]
        var = self.covariances[:, idx, idx]          # [K]
        z = (x[None, :] - mu[:, None]) ** 2 / var[:, None]
        comp = np.exp(-0.5 * z) / np.sqrt(2.0 * np.pi * var[:, None])
        return x, (self.weights[:, None] * comp).sum(axis=0)

    def marginal_pdf_1d_range(self, xlim, idx, n_samples=200):
        """Marginal density of feature `idx` over a uniform grid
        (reference eval_1d_marginal_pdf, controlbehavior.py:309-332)."""
        return self.marginal_pdf_1d(
            np.linspace(xlim[0], xlim[1], n_samples), idx)

    def marginal_pdf_2d(self, xlim, ylim, idx_x, idx_y, n_samples=200):
        """Joint marginal density of features (idx_x, idx_y) on an
        n x n grid (reference eval_2d_marginal_pdf,
        controlbehavior.py:334-377).

        Returns (locations [n*n, 2], densities [n*n])."""
        x = np.linspace(xlim[0], xlim[1], n_samples)
        y = np.linspace(ylim[0], ylim[1], n_samples)
        X, Y = np.meshgrid(x, y)
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)       # [P, 2]
        sel = [idx_x, idx_y]
        mu = self.means[:, sel]                              # [K, 2]
        cov = self.covariances[:, sel][:, :, sel]            # [K, 2, 2]
        det = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] * cov[:, 1, 0]
        d = pts[None, :, :] - mu[:, None, :]                 # [K, P, 2]
        # quadratic form through the analytic 2x2 inverse
        q = (cov[:, 1, 1, None] * d[:, :, 0] ** 2
             - 2.0 * cov[:, 0, 1, None] * d[:, :, 0] * d[:, :, 1]
             + cov[:, 0, 0, None] * d[:, :, 1] ** 2) / det[:, None]
        comp = np.exp(-0.5 * q) / (2.0 * np.pi * np.sqrt(det[:, None]))
        return pts, (self.weights[:, None] * comp).sum(axis=0)


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

    def fit(self, X, features, log_transform=True, normalize=True):
        """Fit the pipeline on raw feature data [n, F] (reference
        fit_transform, controlbehavior.py:884-914): log-shift on
        'real'/'mag' features with a = 0.9 min(sign*x), then Yeo-Johnson
        (lambda via MLE grid) with standardization."""
        X = np.asarray(X, dtype=float)
        self.n_features = X.shape[1]
        Xt = X.copy()
        if log_transform:
            import re as _re
            idx = [i for i, f in enumerate(features)
                   if (m := _re.findall(r"p\d_(.{1,5})", f))
                   and m[0] in ("real", "mag")]
            self.log_features = np.asarray(idx, dtype=int)
            sub = X[:, idx]
            self.log_sign = np.sign(sub[0, :])
            sub = sub * self.log_sign
            self.log_a = 0.9 * np.min(sub, axis=0)
            Xt[:, idx] = np.log(sub - self.log_a)
        from scipy.stats import yeojohnson as _scipy_yj
        lams = np.array([_scipy_yj(Xt[:, j])[1]
                         for j in range(self.n_features)])
        self.lambdas = lams
        Xt = yeojohnson(Xt, lams)
        if normalize:
            self.scaler_mean = Xt.mean(axis=0)
            self.scaler_scale = Xt.std(axis=0)
            Xt = (Xt - self.scaler_mean) / self.scaler_scale
            self.n_samples_seen = X.shape[0]
        return Xt


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
    component means as linear functions of speed, YAML import and export,
    and sampling with stability rejection (controlbehavior.py:1339-1469,
    numpy's generators as in the JAX package); the runtime sampler is
    `PoleModelRT`."""

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

    @classmethod
    def import_from_yaml(cls, filepath):
        """The model of one of the reference's YAML parameter files
        (PyYAML, imported here: the card's machine may lack it)."""
        import yaml

        with open(filepath) as f:
            data = yaml.safe_load(f)
        return cls.from_dict(data)

    def export_to_yaml(self, filepath):
        """Write the model in the reference's YAML schema
        (controlbehavior.py:1987-2137)."""
        import yaml

        pre = self.preprocessing
        pp = dict(
            power_transform=("yeo-johnson" if pre.lambdas is not None
                             else "none"),
            normalize=pre.scaler_mean is not None,
            log_transform=pre.has_log,
            power_transform_params=(
                {"lambdas": pre.lambdas.tolist()}
                if pre.lambdas is not None else {}),
            standard_scaler_params=(
                {"mean": pre.scaler_mean.tolist(),
                 "scale": pre.scaler_scale.tolist(),
                 "n_samples_seen": int(pre.n_samples_seen)}
                if pre.scaler_mean is not None else {}),
            log_transform_params=(
                {"a": pre.log_a.reshape(1, -1).tolist(),
                 "sign": pre.log_sign.reshape(1, -1).tolist(),
                 "log_transform_features": pre.log_features.tolist()}
                if pre.has_log else {}),
        )
        gmd = dict(
            means=self.gmm.means.tolist(),
            covariances=self.gmm.covariances.tolist(),
            weights=self.gmm.weights.tolist(),
            n_features=int(self.gmm.n_features),
            n_components=int(self.gmm.n_components),
            covariance_type="full",
        )
        gmd.update(self.metadata.get("scores", {}))
        presets = dict(self.metadata.get("presets", {}))
        presets["feature_set"] = self.feature_set
        presets.setdefault("features", list(self.features))
        data = dict(presets=presets, gmm_data=gmd,
                    preprocessing_pipeline=pp,
                    metadata=dict(data_created=str(datetime.now())))
        with open(filepath, "w") as f:
            yaml.dump(data, f)

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

    # ---- sampling

    def sample_pole_features(self, n_samples, v=None, rng=None,
                             max_retries=100):
        """Sample raw pole features; resamples non-finite inverse-transform
        results (reference PoleModel.sample, controlbehavior.py:1339-1412).
        """
        rng = rng or np.random.default_rng()
        if self.is_conditional:
            if v is None:
                raise ValueError("conditional pole model: pass the speed v")
            g = conditional_gmm(self.gmm, self.idx_given,
                                self._transform_given(v)[0])
        else:
            g = self.gmm
        samples, labels = g.sample(n_samples, rng)
        out = self.preprocessing.inverse_transform(
            samples, sparse_column_indices=self._rest_indices())
        for _ in range(max_retries):
            bad = ~np.all(np.isfinite(out), axis=1)
            if not np.any(bad):
                return out, labels
            res, lab = g.sample(int(bad.sum()), rng)
            out[bad] = self.preprocessing.inverse_transform(
                res, sparse_column_indices=self._rest_indices())
            labels[bad] = lab
        raise RuntimeError("Sampling error!")

    def sample_poles(self, n_samples=1, X_given=None, rng=None,
                     ensure_stable=True, max_retries=1000):
        """Sample complex pole sets, rejecting unstable draws (reference
        sample_poles, controlbehavior.py:1414-1469)."""
        feats, labels = self.sample_pole_features(n_samples, X_given, rng)
        names = [self.features[i] for i in self._rest_indices()]
        poles = pole_features_to_poles(feats, names)
        if ensure_stable:
            rng = rng or np.random.default_rng()
            for _ in range(max_retries):
                bad = np.any(np.real(poles) > 0, axis=1)
                if not np.any(bad):
                    return poles, labels
                f2, l2 = self.sample_pole_features(int(bad.sum()), X_given,
                                                   rng)
                poles[bad] = pole_features_to_poles(f2, names)
                labels[bad] = l2
            raise TimeoutError(
                f"Couldn't find {n_samples} stable poles after "
                f"{max_retries} draws!")
        return poles, labels


def fit_pole_model(raw_features, feature_set,
                   range_components=(1, 5),
                   covariance_types=("full", "tied", "diag", "spherical"),
                   k_crossval=10, n_init=20, log_transform=True,
                   normalize=True, seed=0, verbose=False,
                   device="cuda") -> PoleModel:
    """Fit a pole model from raw pole-feature data [n, F].

    The reference's full fitting pipeline (PoleModel.fit_optimize +
    PreprocessingPipeline.fit_transform, controlbehavior.py:884-914,
    1273-1334): fit the log-shift / Yeo-Johnson / scaler preprocessing,
    then grid-search a (conditional-capable) GMM over n_components x
    covariance_type with k-fold CV -- here EM runs as a restart batch on
    `device` (see gmm_fit).
    """
    from cyclistsocialforce_tpu_torch import gmm_fit

    features, _ = PREDEFINED_FEATURE_SETS[feature_set]
    X = np.asarray(raw_features, dtype=float)
    if X.shape[1] != len(features):
        raise ValueError(
            f"feature_set {feature_set} expects {len(features)} columns "
            f"({features}), got {X.shape[1]}")
    pre = Preprocessing(n_features=X.shape[1])
    Xt = pre.fit(X, features, log_transform=log_transform,
                 normalize=normalize)
    gmm, info = gmm_fit.fit_optimize(
        Xt, range_components=range_components,
        covariance_types=covariance_types, k_crossval=k_crossval,
        n_init=n_init, seed=seed, verbose=verbose, device=device)
    meta = {"presets": {"feature_set": feature_set,
                        "features": list(features),
                        "gridsearch_selection_metric": "NLL",
                        "n_gmm_inits": n_init,
                        "riderbike_model": None},
            "scores": {"scores_val": info["scores_val"],
                       "scores_test": info["scores_train"],
                       "n_samples_train": int(X.shape[0]),
                       "n_samples_test": 0,
                       "k_crossval": k_crossval}}
    return PoleModel(feature_set=feature_set, gmm=gmm, preprocessing=pre,
                     metadata=meta)


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


def _yj(x, lam):
    """Yeo-Johnson of x with lambdas `lam` (broadcast), as the JAX
    package's `PoleModelRT._yj` writes it."""
    pos = x >= 0
    y_pos = torch.where(lam.abs() < 1e-19, torch.log1p(x.abs()),
                        ((x.abs() + 1.0) ** lam - 1.0)
                        / torch.where(lam == 0, 1.0, lam))
    xn = torch.clamp_max(x, 0.0)
    y_neg = torch.where((lam - 2.0).abs() < 1e-19, -torch.log1p(-xn),
                        -((1.0 - xn) ** (2.0 - lam) - 1.0)
                        / torch.where(lam == 2.0, 1.0, 2.0 - lam))
    return torch.where(pos, y_pos, y_neg)


def _yj_inv(y, lam):
    """Inverse Yeo-Johnson (NaN out of the domain), as `PoleModelRT._yj_inv`
    of the JAX package."""
    pos = y >= 0
    base_p = lam * y + 1.0
    x_pos = torch.where(
        lam.abs() < 1e-19, torch.expm1(y),
        torch.where(base_p > 0, base_p, math.nan)
        ** (1.0 / torch.where(lam == 0, 1.0, lam)) - 1.0)
    base_n = -(2.0 - lam) * y + 1.0
    x_neg = torch.where(
        (lam - 2.0).abs() < 1e-19, 1.0 - torch.exp(-y),
        1.0 - torch.where(base_n > 0, base_n, math.nan)
        ** (1.0 / torch.where(lam == 2.0, 1.0, 2.0 - lam)))
    return torch.where(pos, x_pos, x_neg)


@dataclass(frozen=True)
class PoleModelRT:
    """A conditional pole model as the simulation samples it (counterpart
    of the JAX package's `behavior.PoleModelRT`): conditioning on the
    speed, the component choice, the Gaussian draw through each
    component's conditional Cholesky factor, the inverse preprocessing and
    a stability check, over a batch of riders at once. The reference's
    unbounded rejection loops become REJECT_ROUNDS fixed rounds, all drawn
    up front: the first stable, finite round is taken, and a rider with
    none falls back to the conditional mean of its most likely component.

    The arrays are float64 torch tensors, shared by the population; `to`
    gives the same model in another dtype and device (what a step reads,
    `models.balancingrider.step_constants`). The conditional covariance
    does not depend on the speed, so its Cholesky factor [K, F-1, F-1] is
    a constant of `from_polemodel`. Indices are Python ints: nothing here
    builds an index tensor from a list on the host, reads a value back or
    depends on the data in its shapes."""

    means: torch.Tensor        # [K, F]
    cov_chol: torch.Tensor     # [K, F-1, F-1]
    covariances: torch.Tensor  # [K, F, F]
    weights: torch.Tensor      # [K]
    lambdas: torch.Tensor      # [F]
    scaler_mean: torch.Tensor  # [F]
    scaler_scale: torch.Tensor  # [F]
    log_a: torch.Tensor | None     # [n_log]
    log_sign: torch.Tensor | None  # [n_log]
    log_features: tuple = ()
    idx_given: int = 0
    n_features: int = 6

    REJECT_ROUNDS = 8

    def __post_init__(self):
        # the constants of the conditioning and of the inverse transform,
        # per sampled feature, sliced here once: an index list applied in
        # a step would copy it to the device
        ig, rest = self.idx_given, self.rest
        cov = self.covariances
        var_g = cov[:, ig, ig]
        derived = dict(
            _var_g=var_g, _ratio=cov[:, rest, ig] / var_g[:, None],
            _means_g=self.means[:, ig], _means_r=self.means[:, rest],
            _log_w=torch.log(self.weights),
            _log_norm=0.5 * torch.log(2 * math.pi * var_g),
            _scale_r=self.scaler_scale[rest], _mean_r=self.scaler_mean[rest],
            _lam_r=self.lambdas[rest])
        for name, value in derived.items():
            object.__setattr__(self, name, value)

    @classmethod
    def from_arrays(cls, means, cov_chol, covariances, weights, lambdas,
                    scaler_mean, scaler_scale, log_a=None, log_sign=None,
                    log_features=(), idx_given=0, n_features=6):
        """The model from numpy-convertible arrays (float64 on the CPU)."""
        def t(a):
            return None if a is None else torch.from_numpy(
                np.array(a, dtype=np.float64))

        return cls(t(means), t(cov_chol), t(covariances), t(weights),
                   t(lambdas), t(scaler_mean), t(scaler_scale), t(log_a),
                   t(log_sign), tuple(int(i) for i in log_features),
                   int(idx_given), int(n_features))

    @classmethod
    def from_polemodel(cls, pm: PoleModel) -> "PoleModelRT":
        if not pm.is_conditional:
            raise ValueError("PoleModelRT requires a conditional model")
        pre = pm.preprocessing
        ig = int(pm.idx_given)
        f = int(pm.gmm.n_features)
        rest = [i for i in range(f) if i != ig]
        chols = []
        for k in range(pm.gmm.n_components):
            cov = np.asarray(pm.gmm.covariances[k])
            cov_rg = cov[rest, ig]
            cov_c = cov[np.ix_(rest, rest)] - np.outer(
                cov_rg, cov_rg) / cov[ig, ig]
            chols.append(np.linalg.cholesky(cov_c))
        return cls.from_arrays(
            pm.gmm.means, np.stack(chols), pm.gmm.covariances,
            pm.gmm.weights, pre.lambdas, pre.scaler_mean, pre.scaler_scale,
            pre.log_a if pre.has_log else None,
            pre.log_sign if pre.has_log else None,
            tuple(pre.log_features) if pre.has_log else (), ig, f)

    def to(self, dtype=None, device=None) -> "PoleModelRT":
        """The same model with its tensors in `dtype` on `device`."""
        def t(a):
            return None if a is None else a.to(dtype=dtype, device=device)

        return PoleModelRT(
            t(self.means), t(self.cov_chol), t(self.covariances),
            t(self.weights), t(self.lambdas), t(self.scaler_mean),
            t(self.scaler_scale), t(self.log_a), t(self.log_sign),
            self.log_features, self.idx_given, self.n_features)

    @property
    def rest(self) -> list:
        """The indices of the sampled features (all but the given one)."""
        return [i for i in range(self.n_features) if i != self.idx_given]

    @property
    def n_components(self) -> int:
        return self.weights.shape[0]

    def transform_given(self, v):
        """Raw speeds v [...] -> model space [...]."""
        ig = self.idx_given
        y = _yj(v, self.lambdas[ig])
        return (y - self.scaler_mean[ig]) / self.scaler_scale[ig]

    def inverse_transform_rest(self, x_rest):
        """Model-space features without the given one [..., F-1] -> raw.
        Elementwise per feature, so only the sampled columns are
        transformed."""
        rest = self.rest
        x = _yj_inv(x_rest * self._scale_r + self._mean_r, self._lam_r)
        logs = [(rest.index(i), j) for j, i in enumerate(self.log_features)
                if i in rest]
        if not logs:
            return x
        cols = list(x.unbind(-1))
        for c, j in logs:
            cols[c] = (torch.exp(cols[c]) + self.log_a[j]) * self.log_sign[j]
        return torch.stack(cols, dim=-1)

    def conditional(self, v):
        """Condition on raw speeds v [...]: (means [..., K, F-1], the
        constant Cholesky factors [K, F-1, F-1], weights [..., K]) in
        model space (reference controlbehavior.py:478-530)."""
        d = self.transform_given(v)[..., None] - self._means_g   # [..., K]
        mu_c = self._means_r + self._ratio * d[..., None]
        logw = self._log_w - 0.5 * d * d / self._var_g - self._log_norm
        e = torch.exp(logw - logw.amax(dim=-1, keepdim=True))
        return mu_c, self.cov_chol, e / e.sum(dim=-1, keepdim=True)

    def _ok(self, f):
        """[...]: a draw f [..., F-1] is finite and stable (every real-part
        feature, the log-transformed ones, negative; reference sample_poles
        stability check, controlbehavior.py:1459-1466)."""
        ok = torch.isfinite(f).all(dim=-1)
        rest = self.rest
        for i in self.log_features:
            if i in rest:
                ok = ok & (f[..., rest.index(i)] < 0)
        return ok

    def _draws(self, mu_c, w, comp, z):
        """The raw features of the draws [..., R, F-1] of components comp
        [..., R] with normals z [..., R, F-1] from (mu_c [..., K, F-1],
        weights w [..., K]); their ok flags, and the fallback [..., F-1]:
        the conditional mean of the most likely component."""
        mu = torch.gather(mu_c, -2, comp[..., None].expand(
            comp.shape + mu_c.shape[-1:]))
        lz = (self.cov_chol[comp] * z[..., None, :]).sum(dim=-1)
        cand = self.inverse_transform_rest(mu + lz)
        best = torch.argmax(w, dim=-1, keepdim=True)
        fallback = self.inverse_transform_rest(torch.gather(
            mu_c, -2, best[..., None].expand(
                best.shape + mu_c.shape[-1:]))[..., 0, :])
        return cand, self._ok(cand), fallback

    @staticmethod
    def _first_ok(cand, ok, fallback):
        """The first round's draw that is ok, else the fallback; and
        whether one was: (features [..., F-1], [...] bool)."""
        first = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)
        take = torch.gather(cand, -2, first[..., None].expand(
            first.shape + cand.shape[-1:]))[..., 0, :]
        good = ok.any(dim=-1)
        return torch.where(good[..., None], take, fallback), good

    def sample_features_batch(self, key, v):
        """Population draw: speeds v [N] -> ([N, F-1] features, [N] ok),
        the JAX package's `sample_features_batch` bit for bit in its
        random draws. `key` is one key [2] (a uniform [N, R] and a normal
        [N, R, F-1] from its split) or per-agent keys [N, 2] (each split
        into a uniform [R] and a normal [R, F-1]: what the simulation
        draws, from `state.agent_streams`). The component of round r is
        the number of cumulative weights below u[r]."""
        rounds, fm1 = self.REJECT_ROUNDS, self.n_features - 1
        dtype = self.means.dtype
        ku, kz = rnd.split(key).unbind(-2)
        if key.ndim == 2:
            u = rnd.uniform(ku, (rounds,), dtype)
            z = rnd.normal(kz, (rounds, fm1), dtype)
        else:
            n = v.shape[0]
            u = rnd.uniform(ku, (n, rounds), dtype)
            z = rnd.normal(kz, (n, rounds, fm1), dtype)
        mu_c, _, w = self.conditional(v)
        cumw = torch.cumsum(w, dim=-1)
        comp = torch.clamp_max((u[..., None] > cumw[..., None, :]).sum(
            dim=-1), self.n_components - 1)
        return self._first_ok(*self._draws(mu_c, w, comp, z))

    def sample_features_info(self, key, v):
        """One stable, finite draw [..., F-1] per key of the batch [..., 2]
        at speeds v (broadcast), and whether a rejection round succeeded
        (False: the fallback), as the JAX package's `sample_features_info`
        draws it: R keys split from each key, each split into a
        `jax.random.choice` of the component by the weights and a normal
        [F-1]."""
        fm1 = self.n_features - 1
        keys = rnd.split(key, self.REJECT_ROUNDS)             # [..., R, 2]
        kc, kn = rnd.split(keys).unbind(-2)
        mu_c, _, w = self.conditional(v)
        batch = keys.shape[:-2]
        mu_c = mu_c.expand(batch + mu_c.shape[-2:])
        w = w.expand(batch + w.shape[-1:])
        cumw = torch.cumsum(w, dim=-1)
        comp = rnd.choice_index(kc, cumw[..., None, :].expand(
            kc.shape[:-1] + cumw.shape[-1:]))
        comp = torch.clamp_max(comp, self.n_components - 1)
        z = rnd.normal(kn, (fm1,), self.means.dtype)
        return self._first_ok(*self._draws(mu_c, w, comp, z))

    def sample_features(self, key, v):
        """One stable, finite draw [..., F-1] per key at speeds v."""
        return self.sample_features_info(key, v)[0]


def combine_outliers(outliers_by_model):
    """Combine per-model outlier flags into one any-model mask
    (reference controlbehavior.get_outliers_all_models,
    controlbehavior.py:41-63 -- there a pandas merge over per-model
    CSVs keyed by sample_id; here a file-format-free equivalent over
    {model_name: (sample_ids, outlier_flags)} or plain flag arrays).

    Returns (sample_ids, combined [S] bool) where combined[s] is True if
    ANY model flags that sample. Models may list samples in different
    orders; ids missing from a model are treated as not flagged by it."""
    ids = None
    per_model = {}
    for name, entry in outliers_by_model.items():
        if isinstance(entry, tuple):
            sid, flags = entry
        else:
            flags = entry
            sid = np.arange(len(flags))
        sid = np.asarray(sid)
        flags = np.asarray(flags, dtype=bool)
        if sid.shape != flags.shape:
            raise ValueError(f"model {name!r}: ids and flags must align")
        per_model[name] = (sid, flags)
        ids = sid if ids is None else np.union1d(ids, sid)
    combined = np.zeros(ids.shape, dtype=bool)
    for sid, flags in per_model.values():
        pos = np.searchsorted(ids, sid)
        combined[pos] |= flags
    return ids, combined


__all__ = ["DATA_DIR", "GMMData", "PREDEFINED_FEATURE_SETS", "PoleModel",
           "PoleModelRT", "Preprocessing", "combine_outliers",
           "conditional_gmm", "fit_pole_model", "load_packaged_polemodel",
           "packaged_polemodel_path", "pole_features_to_poles",
           "yeojohnson", "yeojohnson_inverse"]
