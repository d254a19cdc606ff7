"""The balancing rider under upstream's stochastic control behavior
(cyclistsocialforce v2.1.1, `BalancingRiderParameters(
stochastic_control_behavior=True)`, parameters.py:1376-1411): each rider
carries pole features drawn from the BR1 conditional pole model given its
speed, draws again wherever its speed changed and has moved more than
`controlparam_resampling_speedthresh` from the speed of its last draw,
and its gains place the closed-loop poles those features encode.

The pole model (`../data/`, a copy of upstream's parameter file) is a
Gaussian mixture over [v_mean, p0_real, p1_real, p1_imag, p2_real,
p2_imag] in the space of its preprocessing: a log shift of the real parts
(x -> log(x / sign - a)), Yeo-Johnson, standard scaling. Given a speed,
each component's mean of the five features is conditioned on the speed's
transform, and its weight multiplied by its density there. A draw takes
a component by a uniform against the cumulative weights, adds that
component's conditional Cholesky factor times five standard normals to
its conditional mean, and maps the sum back through the inverse
preprocessing. It passes where it is finite and every real part is
negative (a stable rider).

The gains: at the start the Ackermann placement of each rider's first
draw at its initial speed (`..whipple.ackermann`, float64 numpy); in a
step, wherever the speed changed, K = charpoly(features) M(v_mid), where
the Ackermann basis M(v) [6, 5] (row j the gains that the characteristic
polynomial's j-th coefficient alone gives) is this module's own piecewise
quintic over [2, 10] m/s, fitted as K(v) is (`..whipple.fit_poly`),
speeds below the band clamped to its edge; elsewhere the cached gains.
The dynamics are the balancing rider's (`balancingrider`).

The state keeps the features in dyn_gains[:, 5:10] and the speed of the
last draw in dyn_gains[:, 10]. It reads the master key, each rider's uid
and the global step t_glob (`EXTRA_FIELDS`), from which each rider's
stream is derived (`..random.stream`: salt 3 for the first draw, 2 in
the step); the master key is that of seed 0, as the program's state
starts with it.

Departures from upstream, which draws from numpy's global generator and
rejects until a draw passes:
- the streams are JAX's threefry streams, keyed by (key, t_glob, uid,
  salt), in place of numpy's;
- a draw takes 8 rounds, each a component and five normals, fixed in
  advance: the first round that passes, else the conditional mean of the
  most likely component;
- the draws are made in the configuration's dtype and promoted to the
  reference's (`..random`);
- M(v) is a fitted piecewise quintic in place of a placement in every
  step, as the configuration's `gains_poly` states.
"""

import json
import os

import numpy as np
import torch

from .. import random as rnd
from .. import whipple
from ..step import angle_difference, clip, limit_angle
from .balancingrider import gains_poly, solve5

EXTRA_FIELDS = ("key", "uid", "t_glob")
SALT_STEP, SALT_INIT = 2, 3
# the master key's seed: the program's state keeps make_state's default
SEED = 0
ROUNDS = 8


# ---- the conditional pole model -------------------------------------------

def pole_model(filename: str, dtype, device) -> dict:
    """The constants of the conditional pole model in `filename` (its
    JSON copy in `whipple.DATA`), in `dtype` on `device`."""
    with open(os.path.join(whipple.DATA, os.path.splitext(filename)[0]
                           + ".json")) as f:
        data = json.load(f)
    pp, gmd = data["preprocessing_pipeline"], data["gmm_data"]
    names = data["presets"]["features"]
    g = names.index("v_mean")
    rest = [i for i in range(len(names)) if i != g]
    lam = np.asarray(pp["power_transform_params"]["lambdas"])
    if np.any(np.isin(lam[rest], (0.0, 2.0))):
        raise ValueError("the inverse Yeo-Johnson here takes no lambda of "
                         "0 or 2")
    mean = np.asarray(pp["standard_scaler_params"]["mean"])
    scale = np.asarray(pp["standard_scaler_params"]["scale"])
    logt = pp["log_transform_params"]
    mu = np.asarray(gmd["means"])
    cov = np.asarray(gmd["covariances"])
    var_g = cov[:, g, g]
    cov_rg = cov[:, rest, g]
    cond_cov = (cov[:, rest][:, :, rest] - cov_rg[:, :, None]
                * cov_rg[:, None, :] / var_g[:, None, None])

    def t(a):
        return torch.tensor(np.asarray(a, dtype=float), dtype=dtype,
                            device=device)

    return {"lam_g": float(lam[g]), "mean_g": float(mean[g]),
            "scale_g": float(scale[g]), "mu_g": t(mu[:, g]),
            "mu_r": t(mu[:, rest]), "ratio": t(cov_rg / var_g[:, None]),
            "var_g": t(var_g), "log_w": t(np.log(gmd["weights"])),
            "log_norm": t(0.5 * np.log(2.0 * np.pi * var_g)),
            "chol": t(np.linalg.cholesky(cond_cov)),
            "lam_r": t(lam[rest]), "mean_r": t(mean[rest]),
            "scale_r": t(scale[rest]),
            "log_cols": [rest.index(i)
                         for i in logt["log_transform_features"]],
            "log_a": [float(a) for a in np.ravel(logt["a"])],
            "log_sign": [float(s) for s in np.ravel(logt["sign"])]}


def yeojohnson(x, lam: float):
    """Yeo-Johnson of x with one lambda."""
    xp, xn = torch.clamp_min(x, 0.0), torch.clamp_max(x, 0.0)
    pos = (torch.log1p(xp) if lam == 0.0
           else ((xp + 1.0) ** lam - 1.0) / lam)
    neg = (-torch.log1p(-xn) if lam == 2.0
           else -((1.0 - xn) ** (2.0 - lam) - 1.0) / (2.0 - lam))
    return torch.where(x >= 0, pos, neg)


def yeojohnson_inverse(y, lam):
    """Inverse Yeo-Johnson of y [..., F] with lambdas lam [F] (none 0 or
    2); NaN outside its domain."""
    pos = (lam * y + 1.0) ** (1.0 / lam) - 1.0
    neg = 1.0 - (1.0 - (2.0 - lam) * y) ** (1.0 / (2.0 - lam))
    return torch.where(y >= 0, pos, neg)


def conditional(pm: dict, v):
    """At speeds v [N]: the components' conditional means of the features
    [N, K, 5] and their weights [N, K], in model space."""
    y = (yeojohnson(v, pm["lam_g"]) - pm["mean_g"]) / pm["scale_g"]
    d = y[:, None] - pm["mu_g"]
    means = pm["mu_r"] + pm["ratio"] * d[..., None]
    log_w = pm["log_w"] - 0.5 * d * d / pm["var_g"] - pm["log_norm"]
    return means, torch.softmax(log_w, dim=-1)


def to_features(pm: dict, x):
    """Model space [..., 5] -> pole features [..., 5]."""
    f = yeojohnson_inverse(x * pm["scale_r"] + pm["mean_r"], pm["lam_r"])
    cols = list(f.unbind(-1))
    for c, a, sign in zip(pm["log_cols"], pm["log_a"], pm["log_sign"]):
        cols[c] = (torch.exp(cols[c]) + a) * sign
    return torch.stack(cols, dim=-1)


def stable(pm: dict, f):
    """[...]: the features f [..., 5] are finite and every real part is
    negative."""
    ok = torch.isfinite(f).all(dim=-1)
    for c in pm["log_cols"]:
        ok = ok & (f[..., c] < 0)
    return ok


def sample(pm: dict, keys, v, draw_dtype):
    """One draw of pole features [N, 5] per rider at speeds v [N] from its
    key [N, 2]: the key split in two, a uniform [8] from the first and
    normals [8, 5] from the second, drawn in `draw_dtype` and promoted to
    v's dtype; round r takes the component that the number of cumulative
    weights below u[r] names."""
    n = v.shape[0]
    ku, kz = rnd.split(keys).unbind(-2)
    u = rnd.uniform(ku, (ROUNDS,), draw_dtype).to(v.dtype)
    z = rnd.normal(kz, (ROUNDS, 5), draw_dtype).to(v.dtype)
    means, w = conditional(pm, v)
    k = w.shape[1]
    cum = torch.cumsum(w, dim=-1)
    comp = torch.clamp_max((u[..., None] > cum[:, None, :]).sum(dim=-1),
                           k - 1)                              # [N, 8]
    rows = torch.arange(n, device=v.device)
    lz = (pm["chol"][comp] * z[..., None, :]).sum(dim=-1)      # [N, 8, 5]
    cand = to_features(pm, means[rows[:, None], comp] + lz)
    first = torch.where(stable(pm, cand),
                        torch.arange(ROUNDS, device=v.device),
                        ROUNDS).amin(dim=1)
    taken = cand[rows, torch.clamp_max(first, ROUNDS - 1)]
    fallback = to_features(pm, means[rows, w.argmax(dim=1)])
    return torch.where((first < ROUNDS)[:, None], taken, fallback)


# ---- the gains -------------------------------------------------------------

def charpoly(f):
    """The monic characteristic polynomial [N, 6] (highest power first) of
    the poles [p0, p1 +/- j q1, p2 +/- j q2] that the features f [N, 5]
    encode."""
    one = torch.ones_like(f[:, 0])
    poly = [one, -f[:, 0]]
    for i in (1, 3):
        p, q = f[:, i], f[:, i + 1]
        quad = (one, -2.0 * p, p * p + q * q)
        new = [0.0] * (len(poly) + 2)
        for j, a in enumerate(poly):
            for k, b in enumerate(quad):
                new[j + k] = new[j + k] + a * b
        poly = new
    return torch.stack(poly, dim=1)


def ackermann_basis(mats, v):
    """M(v) [len(v), 6, 5] (float64 numpy): row j the placement's gains of
    the polynomial whose j-th coefficient alone is 1, so that the gains
    of any monic polynomial c are c M(v)."""
    A0, A1, A2, B = mats
    v = np.asarray(v, dtype=float)
    A = (A0[None] + v[:, None, None] * A1[None]
         + (v ** 2)[:, None, None] * A2[None])
    eye = np.eye(6)
    return np.stack([whipple.ackermann(A, B, np.broadcast_to(
        eye[j], (len(v), 6))) for j in range(6)], axis=1)


def basis_gains(c: dict, feats, v):
    """K [N, 5] = charpoly(feats) M(v) from the fitted basis."""
    M = gains_poly(c["basis_fit"], v).reshape(-1, 6, 5)
    return (charpoly(feats)[:, :, None] * M).sum(dim=1)


# ---- the model's interface ------------------------------------------------

def constants(cfg: dict, dtype, device) -> dict:
    """A0, A1, A2, B, the pole model, the basis fit, the speed threshold
    and the dtype of the draws, worked out from the configuration file
    alone. Only upstream's resampling is stepped here: no budget, a draw
    on every step that needs one."""
    create = cfg["create"]
    if (int(create.get("resample_budget", 0)) != 0
            or int(create.get("resample_every", 1)) != 1):
        raise ValueError("the reference resamples every rider that needs "
                         "it on every step (resample_budget 0, "
                         "resample_every 1)")
    mats = whipple.system_matrices(create["bicycle_parameter_dict"])
    # M(v) flattened row by row, m = 5 j + k
    coeffs, lo, seg = whipple.fit_poly(
        lambda v: ackermann_basis(mats, v).reshape(len(v), 30),
        float(cfg["params"]["v_max_riding"][1]), int(create["gains_poly"]))
    c = {"mats": mats,
         "basis_fit": {"poly": torch.tensor(coeffs, dtype=dtype,
                                            device=device),
                       "poly_lo": lo, "poly_seg": seg},
         "pole_model": pole_model(create["controlparam_filename"], dtype,
                                  device),
         "thresh": float(create["controlparam_resampling_speedthresh"]),
         "draw_dtype": getattr(torch, cfg["dtype"])}
    for key, a in zip(("A0", "A1", "A2", "B"), mats):
        c[key] = torch.tensor(a, dtype=dtype, device=device)
    return c


def initial(st: dict, c: dict) -> dict:
    """The random streams' fields, the bike-frame latents, and each
    rider's first draw (salt 3, at its initial speed, where that passes
    the threshold from 0) with the exact placement of its poles there."""
    s = st["s"]
    rows, dev = s.shape[0], s.device
    key = rnd.prng_key(SEED, dev)
    uid = torch.arange(rows, dtype=torch.int32, device=dev)
    t_glob = torch.zeros((), dtype=torch.int32, device=dev)
    v0 = s[:, 3]
    drawn = sample(c["pole_model"], rnd.stream(key, t_glob, uid, SALT_INIT),
                   v0, c["draw_dtype"])
    feats = torch.where((v0.abs() > c["thresh"])[:, None], drawn, 0.0)
    A0, A1, A2, B = c["mats"]
    v = v0.cpu().numpy()
    A = (A0[None] + v[:, None, None] * A1[None]
         + (v ** 2)[:, None, None] * A2[None])
    K = whipple.ackermann(A, B, whipple.charpoly(feats.cpu().numpy()))
    gains = torch.zeros((rows, 12), dtype=s.dtype, device=dev)
    gains[:, :5] = torch.as_tensor(K, device=dev)
    gains[:, 5:10] = feats
    gains[:, 10] = v0
    return {"dyn_x": torch.stack([s[:, 5], -s[:, 4], s[:, 7], -s[:, 6],
                                  -s[:, 2], s[:, 0], -s[:, 1]], dim=1),
            "dyn_gains": gains, "key": key, "uid": uid, "t_glob": t_glob}


def step(st: dict, c: dict, fx, fy) -> dict:
    p = c["p"]
    s, x, dg = st["s"], st["dyn_x"], st["dyn_gains"]
    h = p["t_s"]
    v_old = s[:, 3]
    a = clip(p["k_p_v"] * (torch.sqrt(fx * fx + fy * fy) - v_old),
             *p["a_max"])
    v_new = clip(v_old + h * a, *p["v_max_riding"])
    v_mid = (v_new + v_old) / 2.0
    psi_bike = x[:, 4]
    psi_c = psi_bike + angle_difference(psi_bike,
                                        limit_angle(torch.atan2(-fy, fx)))
    # a new draw where the speed changed and moved past the threshold
    # since the last one; gains recomputed where the speed changed
    changed = v_new != v_old
    need = changed & ((v_mid - dg[:, 10]).abs() > c["thresh"])
    drawn = sample(c["pole_model"],
                   rnd.stream(st["key"], st["t_glob"], st["uid"], SALT_STEP),
                   v_mid, c["draw_dtype"])
    feats = torch.where(need[:, None], drawn, dg[:, 5:10])
    v_last = torch.where(need, v_mid, dg[:, 10])
    K = torch.where(changed[:, None], basis_gains(c, feats, v_mid),
                    dg[:, :5])
    # the implicit midpoint of the five bike-rider states
    vv = v_mid[:, None, None]
    Acl = (c["A0"] + vv * c["A1"] + vv * vv * c["A2"]
           - c["B"][:, None] * K[:, None, :])
    x5 = x[:, :5]
    rhs = (x5 + (h / 2.0) * torch.einsum("nij,nj->ni", Acl, x5)
           + h * c["B"] * (K[:, 4] * psi_c)[:, None])
    eye = torch.eye(5, dtype=s.dtype, device=s.device)
    x5n = solve5(eye - (h / 2.0) * Acl, rhs)
    psi_mid = (x[:, 4] + x5n[:, 4]) / 2.0
    px = x[:, 5] + h * v_mid * torch.cos(psi_mid)
    py = x[:, 6] + h * v_mid * torch.sin(psi_mid)
    s_new = torch.stack([px, -py, -limit_angle(x5n[:, 4]), v_new,
                         -limit_angle(x5n[:, 1]), limit_angle(x5n[:, 0]),
                         -x5n[:, 3], x5n[:, 2]], dim=1)
    return {"s": s_new,
            "dyn_x": torch.cat([x5n, px[:, None], py[:, None]], dim=1),
            "dyn_gains": torch.cat([K, feats, v_last[:, None], dg[:, 11:]],
                                   dim=1)}
