"""Gaussian-mixture fitting by batched EM in PyTorch (counterpart of
`cyclistsocialforce_tpu.gmm_fit`; reference controlbehavior.py:1273-1334,
`fit_optimize`: a grid search over n_components x covariance_type with
k-fold cross-validation, 100 EM restarts per fit).

The `n_init` restarts are a leading batch dimension of one EM loop:
[R, N, K, F] tensors, batched Cholesky factors and triangular solves, on
`device` in float64, and the best restart by its final log-likelihood
wins. The k-means++ seeding draws JAX's streams (`ops.random`: the
restart keys are `split(key(seed), n_init)`, each split again per centre
as the JAX package splits it), so both packages start every restart from
the same centres.

The four sklearn covariance types (full, tied, diag, spherical) and the
BIC / AIC / NLL scores of model selection.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.ops import random as rnd

COVARIANCE_TYPES = ("full", "tied", "diag", "spherical")
_REG = 1e-6   # sklearn's reg_covar


def _as_tensor(X, device):
    return torch.as_tensor(np.asarray(X, dtype=np.float64),
                           device=device)


def _cholesky(covs):
    """Lower Cholesky factors of covs [..., F, F]; a factor that does not
    exist is NaN, as JAX's is (torch would raise)."""
    chol, info = torch.linalg.cholesky_ex(covs)
    return torch.where((info != 0)[..., None, None], math.nan, chol)


def _log_gauss_full(X, means, covs):
    """[..., N, K] log N(x_n; mu_k, cov_k) of X [N, F] under means
    [..., K, F] and full covariances [..., K, F, F]."""
    f = X.shape[-1]
    chol = _cholesky(covs)                                  # [..., K, F, F]
    diff = X[..., None, :, :] - means[..., :, None, :]      # [..., K, N, F]
    sol = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2),
                                        upper=False)        # [..., K, F, N]
    maha = torch.sum(sol * sol, dim=-2).transpose(-1, -2)   # [..., N, K]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(
        chol, dim1=-2, dim2=-1)), dim=-1)                   # [..., K]
    return -0.5 * (f * math.log(2 * math.pi) + logdet[..., None, :] + maha)


def _expand_cov(cov, cov_type, k, f):
    """Any covariance parameterization [..., ...] -> full [..., K, F, F]."""
    if cov_type == "full":
        return cov
    eye = torch.eye(f, dtype=cov.dtype, device=cov.device)
    if cov_type == "tied":
        return cov[..., None, :, :].expand(cov.shape[:-2] + (k, f, f))
    if cov_type == "diag":
        return torch.diag_embed(cov)
    if cov_type == "spherical":
        return cov[..., None, None] * eye
    raise ValueError(cov_type)


# --------------------------------------------------------------------------
# EM over a batch of restarts [R, ...]
# --------------------------------------------------------------------------


def _m_step(X, resp, cov_type):
    """Means [R, K, F], covariances and weights [R, K] from the
    responsibilities resp [R, N, K]."""
    n, f = X.shape
    nk = torch.sum(resp, dim=-2) + 1e-10                    # [R, K]
    weights = nk / n
    means = (resp.transpose(-1, -2) @ X) / nk[..., None]    # [R, K, F]
    diff = X[None, :, None, :] - means[:, None, :, :]       # [R, N, K, F]
    eye = torch.eye(f, dtype=X.dtype, device=X.device)
    if cov_type == "full":
        cov = torch.einsum("rnk,rnki,rnkj->rkij", resp, diff, diff) \
            / nk[..., None, None]
        cov = cov + _REG * eye
    elif cov_type == "tied":
        cov = torch.einsum("rnk,rnki,rnkj->rij", resp, diff, diff) / n
        cov = cov + _REG * eye
    elif cov_type == "diag":
        cov = torch.einsum("rnk,rnki->rki", resp, diff * diff) \
            / nk[..., None] + _REG
    else:  # spherical
        cov = torch.mean(torch.einsum("rnk,rnki->rki", resp, diff * diff)
                         / nk[..., None], dim=-1) + _REG
    return means, cov, weights


def _e_step(X, means, cov, weights, cov_type):
    """(responsibilities [R, N, K], mean log-likelihood [R])."""
    k, f = means.shape[-2:]
    logp = _log_gauss_full(X, means, _expand_cov(cov, cov_type, k, f))
    logw = logp + torch.log(weights)[..., None, :]
    norm = torch.logsumexp(logw, dim=-1, keepdim=True)
    return torch.exp(logw - norm), torch.mean(norm[..., 0], dim=-1)


def _kmeanspp_init(keys, X, k):
    """k-means++ seeding of each restart: centres [R, k, F] from restart
    keys [R, 2], each centre after the first drawn with weights the
    squared distance to the nearest centre so far (the JAX package's
    `_kmeanspp_init` draws, from the same keys)."""
    n, f = X.shape
    k0, key = rnd.split(keys).unbind(-2)
    first = rnd.randint(k0, (), 0, n)
    centers = torch.zeros((keys.shape[0], k, f), dtype=X.dtype,
                          device=X.device)
    centers[:, 0] = X[first]
    later = torch.arange(k, device=X.device)
    for i in range(1, k):
        d2 = torch.sum((X[None, :, None, :] - centers[:, None, :, :]) ** 2,
                       dim=-1)                               # [R, N, k]
        d2 = torch.amin(d2 + torch.where(later >= i, math.inf, 0.0), dim=-1)
        key, sub = rnd.split(key).unbind(-2)
        idx = rnd.categorical(sub, torch.log(d2 + 1e-12))
        centers[:, i] = X[idx]
    return centers


def _fit_batch(keys, X, k, cov_type, n_iter):
    """EM of every restart from its seeding: (means [R, K, F],
    covariances, weights [R, K], final NLL [R])."""
    r = keys.shape[0]
    f = X.shape[1]
    means = _kmeanspp_init(keys, X, k)
    var0 = torch.var(X, dim=0, unbiased=False) + _REG
    if cov_type == "full":
        cov = torch.diag(var0).expand(r, k, f, f)
    elif cov_type == "tied":
        cov = torch.diag(var0).expand(r, f, f)
    elif cov_type == "diag":
        cov = var0.expand(r, k, f)
    else:
        cov = torch.mean(var0).expand(r, k)
    weights = torch.full((r, k), 1.0 / k, dtype=X.dtype, device=X.device)
    ll = None
    for _ in range(n_iter):
        resp, ll = _e_step(X, means, cov, weights, cov_type)
        means, cov, weights = _m_step(X, resp, cov_type)
    return means, cov, weights, -ll


def n_parameters(k, f, cov_type):
    """Free-parameter count (for BIC/AIC), sklearn's `_n_parameters`."""
    if cov_type == "full":
        cov_params = k * f * (f + 1) // 2
    elif cov_type == "tied":
        cov_params = f * (f + 1) // 2
    elif cov_type == "diag":
        cov_params = k * f
    else:
        cov_params = k
    return int(cov_params + k * f + k - 1)


def fit_gmm(X, n_components, covariance_type="full", n_init=100,
            n_iter=200, seed=0, device="cuda"):
    """Fit a GMM by EM with `n_init` restarts advanced as one batch on
    `device`; returns a behavior.GMMData (full-covariance expansion) and
    the training scores {NLL, BIC, AIC}."""
    from cyclistsocialforce_tpu_torch.behavior import GMMData

    X = _as_tensor(X, device)
    keys = rnd.split(rnd.key(seed, device), n_init)
    means, cov, weights, nll = _fit_batch(keys, X, n_components,
                                          covariance_type, n_iter)
    best = int(torch.argmin(nll))
    k, f = n_components, X.shape[1]
    cov_full = _expand_cov(cov[best], covariance_type, k, f)
    n = X.shape[0]
    mean_nll = float(nll[best])
    p = n_parameters(k, f, covariance_type)
    scores = {"NLL": mean_nll,
              "BIC": 2 * mean_nll * n + p * float(np.log(n)),
              "AIC": 2 * mean_nll * n + 2 * p}
    w = weights[best] / torch.sum(weights[best])
    gmm = GMMData(means[best].cpu().numpy(), cov_full.cpu().numpy(),
                  w.cpu().numpy())
    return gmm, scores


def score_nll(gmm, X, device="cuda"):
    """Mean negative log-likelihood of X under a GMMData."""
    X = _as_tensor(X, device)
    logp = _log_gauss_full(X, _as_tensor(gmm.means, device),
                           _as_tensor(gmm.covariances, device))
    lw = logp + torch.log(_as_tensor(gmm.weights, device))[None, :]
    return float(-torch.mean(torch.logsumexp(lw, dim=1)))


def fit_optimize(X, range_components=(1, 5),
                 covariance_types=COVARIANCE_TYPES, k_crossval=10,
                 n_init=20, n_iter=150, selection_metric="NLL", seed=0,
                 verbose=False, device="cuda"):
    """Grid-search model selection with k-fold cross-validation (the
    reference's PoleModel.fit_optimize, controlbehavior.py:1273-1334):
    for every (covariance_type, n_components) pair the held-out score
    averaged over k folds (numpy's permutation of `seed`, as the JAX
    package draws it); the best refitted on all data.

    Returns (GMMData, dict) with the hyperparameters and scores."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k_crossval)

    results = []
    for cov_type in covariance_types:
        for k in range(range_components[0], range_components[1]):
            scores = []
            for i in range(k_crossval):
                test_idx = folds[i]
                train_idx = np.concatenate(
                    [folds[j] for j in range(k_crossval) if j != i])
                gmm, _ = fit_gmm(X[train_idx], k, cov_type, n_init=n_init,
                                 n_iter=n_iter, seed=seed, device=device)
                nll = score_nll(gmm, X[test_idx], device)
                p = n_parameters(k, X.shape[1], cov_type)
                m = len(test_idx)
                scores.append({"NLL": nll,
                               "BIC": 2 * nll * m + p * np.log(m),
                               "AIC": 2 * nll * m + 2 * p})
            mean = {key: float(np.mean([s[key] for s in scores]))
                    for key in ("NLL", "BIC", "AIC")}
            results.append({"cov_type": cov_type, "n_components": k,
                            **mean})
            if verbose:
                print(f"  {cov_type} k={k}: NLL={mean['NLL']:.4f}")

    best = min(results, key=lambda r: r[selection_metric])
    gmm, train_scores = fit_gmm(X, best["n_components"], best["cov_type"],
                                n_init=n_init, n_iter=n_iter, seed=seed,
                                device=device)
    info = {"hyperparameters": {"n_components": best["n_components"],
                                "cov_type": best["cov_type"]},
            "scores_val": {k: best[k] for k in ("NLL", "BIC", "AIC")},
            "scores_train": train_scores,
            "gridsearch": results}
    return gmm, info


def score_gmm(gmm, X, covariance_type="full", device="cuda"):
    """Multimetric {BIC, AIC, NLL} score of a GMMData on samples X
    (reference controlbehavior.score_gmm, controlbehavior.py:116-125:
    NLL the mean negative log-likelihood, BIC and AIC of the full
    sample's)."""
    n, f = np.shape(X)
    nll = score_nll(gmm, X, device)
    p = n_parameters(gmm.n_components, f, covariance_type)
    return {"BIC": 2 * nll * n + p * float(np.log(n)),
            "AIC": 2 * nll * n + 2 * p,
            "NLL": nll}


def score_conditional_gmm(gmm, X, idx_given, covariance_type="full",
                          device="cuda"):
    """Multimetric score of a conditional mixture: each sample's remaining
    features under the mixture conditioned on its given feature, averaged
    (reference controlbehavior.score_conditional_gmm,
    controlbehavior.py:128-153: per-sample sklearn bic/aic on n = 1, where
    the ln(n) BIC penalty vanishes)."""
    from cyclistsocialforce_tpu_torch.behavior import conditional_gmm

    X = np.asarray(X, dtype=float)
    rest = [j for j in range(X.shape[1]) if j != idx_given]
    p = n_parameters(gmm.n_components, len(rest), covariance_type)
    rows = []
    for i in range(X.shape[0]):
        cond = conditional_gmm(gmm, idx_given, float(X[i, idx_given]))
        nll = score_nll(cond, X[i, rest][None, :], device)
        rows.append([2 * nll + p * np.log(1.0), 2 * nll + 2 * p, nll])
    bic, aic, nll = np.mean(np.asarray(rows), axis=0)
    return {"BIC": float(bic), "AIC": float(aic), "NLL": float(nll)}
