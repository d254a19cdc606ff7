"""What the balancing rider's configuration derives before its first step,
worked out in float64 numpy from the configuration file alone: the
linearised Whipple-Carvallo matrices A(v) = A0 + v A1 + v^2 A2 and B
(Meijaard, Papadopoulos, Ruina & Schwab 2007, Appendix A), the rider's
pole features as linear functions of speed (the mean functions of the
upstream BR1 pole model, `data/`, a copy of the upstream parameter file),
the Ackermann placement K(v) of those poles, and K(v) fitted as a
piecewise quintic over speed (the configuration's `gains_poly`)."""

from __future__ import annotations

import json
import os

import numpy as np

DATA = os.path.join(os.path.dirname(__file__), "data")
# the lower edge of the gains fit's speed band: K(v) has poles at v = 0
# and v ~ 1.25 m/s (upstream's BalancingRider stays clear of them)
GAINS_V_LO = 2.0
POLY_DEG, POLY_POINTS = 5, 129


def canonical_matrices(p: dict):
    """(M, C1, K0, K2) [2, 2] of the 27 physical parameters."""
    w, c, lam, g = p["w"], p["c"], p["lam"], p["g"]
    rR, mR, IRxx, IRyy = p["rR"], p["mR"], p["IRxx"], p["IRyy"]
    xB, zB, mB = p["xB"], p["zB"], p["mB"]
    IBxx, IBxz, IBzz = p["IBxx"], p["IBxz"], p["IBzz"]
    xH, zH, mH = p["xH"], p["zH"], p["mH"]
    IHxx, IHxz, IHzz = p["IHxx"], p["IHxz"], p["IHzz"]
    rF, mF, IFxx, IFyy = p["rF"], p["mF"], p["IFxx"], p["IFyy"]
    cl, sl = np.cos(lam), np.sin(lam)
    mT = mR + mB + mH + mF
    xT = (xB * mB + xH * mH + w * mF) / mT
    zT = (-rR * mR + zB * mB + zH * mH - rF * mF) / mT
    ITxx = (IRxx + IBxx + IHxx + IFxx + mR * rR ** 2 + mB * zB ** 2
            + mH * zH ** 2 + mF * rF ** 2)
    ITxz = IBxz + IHxz - mB * xB * zB - mH * xH * zH + mF * w * rF
    ITzz = (IRxx + IBzz + IHzz + IFxx + mB * xB ** 2 + mH * xH ** 2
            + mF * w ** 2)
    mA = mH + mF
    xA = (xH * mH + w * mF) / mA
    zA = (zH * mH - rF * mF) / mA
    IAxx = IHxx + IFxx + mH * (zH - zA) ** 2 + mF * (rF + zA) ** 2
    IAxz = IHxz - mH * (xH - xA) * (zH - zA) + mF * (w - xA) * (rF + zA)
    IAzz = IHzz + IFxx + mH * (xH - xA) ** 2 + mF * (w - xA) ** 2
    uA = (xA - w - c) * cl - zA * sl
    IAll = mA * uA ** 2 + IAxx * sl ** 2 + 2 * IAxz * sl * cl + IAzz * cl ** 2
    IAlx = -mA * uA * zA + IAxx * sl + IAxz * cl
    IAlz = mA * uA * xA + IAxz * sl + IAzz * cl
    mu = c / w * cl
    SR, SF = IRyy / rR, IFyy / rF
    ST = SR + SF
    SA = mA * uA + mu * mT * xT
    M = np.array([[ITxx, IAlx + mu * ITxz],
                  [IAlx + mu * ITxz, IAll + 2 * mu * IAlz + mu ** 2 * ITzz]])
    K0 = np.array([[mT * zT, -SA], [-SA, -SA * sl]])
    K2 = np.array([[0.0, (ST - mT * zT) / w * cl],
                   [0.0, (SA + SF * sl) / w * cl]])
    C1 = np.array([[0.0, mu * ST + SF * cl + ITxz / w * cl - mu * mT * zT],
                   [-(mu * ST + SF * cl),
                    IAlz / w * cl + mu * (SA + ITzz / w * cl)]])
    return M, C1, K0, K2


def system_matrices(p: dict):
    """(A0, A1, A2, B) of the 5-state model [roll, steer, roll rate, steer
    rate, yaw] in the bike frame, steer torque as the input."""
    M, C1, K0, K2 = canonical_matrices(p)
    Minv = np.linalg.inv(M)
    cl, w, c = np.cos(p["lam"]), p["w"], p["c"]
    A0 = np.zeros((5, 5))
    A0[0:2, 2:4] = np.eye(2)
    A0[2:4, 0:2] = -Minv @ (p["g"] * K0)
    A0[4, 3] = cl * c / w
    A1 = np.zeros((5, 5))
    A1[2:4, 2:4] = -Minv @ C1
    A1[4, 1] = cl / w
    A2 = np.zeros((5, 5))
    A2[2:4, 0:2] = -Minv @ K2
    B = np.zeros(5)
    B[2:4] = Minv[:, 1]
    return A0, A1, A2, B


def _yeojohnson(x: float, lam: float) -> float:
    if x >= 0:
        return (np.log1p(x) if abs(lam) < 1e-19
                else ((x + 1.0) ** lam - 1.0) / lam)
    return (-np.log1p(-x) if abs(lam - 2.0) < 1e-19
            else -((1.0 - x) ** (2.0 - lam) - 1.0) / (2.0 - lam))


def _yeojohnson_inverse(y, lam):
    out = np.empty_like(y)
    for i, (yi, li) in enumerate(zip(y, lam)):
        if yi >= 0:
            out[i] = (np.expm1(yi) if abs(li) < 1e-19
                      else (li * yi + 1.0) ** (1.0 / li) - 1.0)
        else:
            out[i] = (1.0 - np.exp(-yi) if abs(li - 2.0) < 1e-19
                      else 1.0 - (-(2.0 - li) * yi + 1.0) ** (1.0 / (2.0 - li)))
    return out


def pole_features_linear(filename: str, component: int = 0):
    """[5, 2] intercept and slope of the mean pole features of one
    component of a conditional pole model over speed: the component's
    conditional mean at 250 speeds of [1.5, 5.5] m/s, mapped back through
    the model's preprocessing (standard scaling, Yeo-Johnson, the log
    shift), fitted by least squares (upstream's mean function)."""
    with open(os.path.join(DATA, os.path.splitext(filename)[0]
                           + ".json")) as f:
        data = json.load(f)
    pp, gmd = data["preprocessing_pipeline"], data["gmm_data"]
    features = data["presets"]["features"]
    given = features.index("v_mean")
    rest = [i for i in range(len(features)) if i != given]
    lam = np.asarray(pp["power_transform_params"]["lambdas"])
    mean = np.asarray(pp["standard_scaler_params"]["mean"])
    scale = np.asarray(pp["standard_scaler_params"]["scale"])
    lt = pp["log_transform_params"]
    log_a = np.asarray(lt["a"]).reshape(-1)
    log_sign = np.asarray(lt["sign"]).reshape(-1)
    log_feats = np.asarray(lt["log_transform_features"], dtype=int)
    mu = np.asarray(gmd["means"][component])
    cov = np.asarray(gmd["covariances"][component])

    vs = np.linspace(1.5, 5.5, 250)
    feats = []
    for v in vs:
        vg = (_yeojohnson(v, lam[given]) - mean[given]) / scale[given]
        mc = mu[rest] + cov[rest, given] / cov[given, given] * (vg - mu[given])
        full = np.zeros(len(features))
        full[rest] = mc
        full = _yeojohnson_inverse(full * scale + mean, lam)
        full[log_feats] = (np.exp(full[log_feats]) + log_a) * log_sign
        feats.append(full[rest])
    X = np.c_[np.ones_like(vs), vs]
    coef, *_ = np.linalg.lstsq(X, np.asarray(feats), rcond=None)
    return coef.T


def charpoly(feats):
    """Monic characteristic polynomial [..., 6] (highest power first) of
    the poles [p0, p1 +/- j q1, p2 +/- j q2] that the features [p0, p1, q1,
    p2, q2] encode."""
    f = np.asarray(feats)
    out = np.ones(f.shape[:-1] + (1,))
    out = np.concatenate([out, -f[..., 0:1]], axis=-1)
    for i in (1, 3):
        p, q = f[..., i], f[..., i + 1]
        quad = np.stack([np.ones_like(p), -2.0 * p, p * p + q * q], axis=-1)
        deg = out.shape[-1] + 2
        new = np.zeros(f.shape[:-1] + (deg,))
        for j in range(out.shape[-1]):
            for k in range(3):
                new[..., j + k] += out[..., j] * quad[..., k]
        out = new
    return out


def ackermann(A, B, coeffs):
    """K [..., 5] placing the eigenvalues of A - B K at the roots of the
    monic polynomial `coeffs` [..., 6] (Ackermann's formula)."""
    n = A.shape[-1]
    cols = [np.broadcast_to(B, A.shape[:-1]).copy()]
    for _ in range(n - 1):
        cols.append(np.einsum("...ij,...j->...i", A, cols[-1]))
    ctrb = np.stack(cols, axis=-1)
    en = np.zeros(A.shape[:-1])
    en[..., -1] = 1.0
    y = np.linalg.solve(np.swapaxes(ctrb, -1, -2), en[..., None])[..., 0]
    At = np.swapaxes(A, -1, -2)
    r = coeffs[..., 0:1] * y
    for k in range(1, n + 1):
        r = np.einsum("...ij,...j->...i", At, r) + coeffs[..., k:k + 1] * y
    return r


def exact_gains(mats, pole_lin, v):
    """K(v) [len(v), 5]: the placement at speeds v of the pole features
    the linear functions give there."""
    A0, A1, A2, B = mats
    v = np.asarray(v, dtype=float)
    A = (A0[None] + v[:, None, None] * A1[None]
         + (v ** 2)[:, None, None] * A2[None])
    feats = pole_lin[:, 0] + pole_lin[:, 1] * v[:, None]
    return ackermann(A, B, charpoly(feats))


def fit_poly(sample, v_hi: float, n_seg: int):
    """[n_seg, M, 6] coefficients (ascending degree, in the local
    coordinate u in [0, 1] of each segment) of a map of speed `sample`
    (v [K] -> [K, M]) fitted by least squares, segment by segment, on 129
    speeds each of [GAINS_V_LO, v_hi]; with the band's lower edge and
    segment width."""
    seg = (v_hi - GAINS_V_LO) / n_seg
    u = np.linspace(0.0, 1.0, POLY_POINTS)
    V = np.vander(u, POLY_DEG + 1, increasing=True)
    coeffs = []
    for s in range(n_seg):
        c, *_ = np.linalg.lstsq(V, sample(GAINS_V_LO + seg * (s + u)),
                                rcond=None)
        coeffs.append(c.T)
    return np.stack(coeffs), GAINS_V_LO, seg


def fit_gains_poly(mats, pole_lin, v_hi: float, n_seg: int):
    """K(v) fitted as a piecewise quintic (`fit_poly`): [n_seg, 5, 6]."""
    return fit_poly(lambda v: exact_gains(mats, pole_lin, v), v_hi, n_seg)
