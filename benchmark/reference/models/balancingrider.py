"""The balancing rider: linearised Whipple-Carvallo dynamics under
full-state feedback, implicit-midpoint integration (upstream
cyclistsocialforce's `BalancingRiderBicycle`), its gains the piecewise
quintic the configuration's `gains_poly` fits (`..whipple`)."""

import torch

from .. import whipple
from ..step import angle_difference, clip, limit_angle


def constants(cfg: dict, dtype, device) -> dict:
    """A0, A1, A2, B, the pole features' linear functions and the gains
    polynomial, worked out from the configuration file alone."""
    create = cfg["create"]
    mats = whipple.system_matrices(create["bicycle_parameter_dict"])
    lin = whipple.pole_features_linear(
        create["controlparam_filename"],
        create.get("controlparam_polemodel_component", 0))
    coeffs, lo, seg = whipple.fit_gains_poly(
        mats, lin, float(cfg["params"]["v_max_riding"][1]),
        int(create["gains_poly"]))
    c = {"mats": mats, "pole_lin": lin, "poly_lo": lo, "poly_seg": seg,
         "poly": torch.tensor(coeffs, dtype=dtype, device=device)}
    for key, a in zip(("A0", "A1", "A2", "B"), mats):
        c[key] = torch.tensor(a, dtype=dtype, device=device)
    return c


def initial(st: dict, c: dict) -> dict:
    """The bike-frame latents [roll, -steer, roll rate, -steer rate, -yaw,
    x, -y] and the gains placed exactly at each rider's initial speed."""
    s = st["s"]
    K = whipple.exact_gains(c["mats"], c["pole_lin"], s[:, 3].cpu().numpy())
    gains = torch.zeros((s.shape[0], 12), dtype=s.dtype, device=s.device)
    gains[:, :5] = torch.as_tensor(K, device=s.device)
    return {"dyn_x": torch.stack([s[:, 5], -s[:, 4], s[:, 7], -s[:, 6],
                                  -s[:, 2], s[:, 0], -s[:, 1]], dim=1),
            "dyn_gains": gains}


def gains_poly(c: dict, v):
    """K(v) [N, 5] from the fitted piecewise quintic; speeds outside the
    band clamp to its edges."""
    coeffs = c["poly"]
    n_seg = coeffs.shape[0]
    u = torch.clamp((v - c["poly_lo"]) / c["poly_seg"], 0.0, n_seg - 1e-6)
    seg = torch.clamp(torch.floor(u).long(), 0, n_seg - 1)
    u = u - seg.to(u.dtype)
    rows = coeffs[seg]                                   # [N, 5, 6]
    acc = rows[..., -1]
    for d in range(rows.shape[-1] - 2, -1, -1):
        acc = acc * u[:, None] + rows[..., d]
    return acc


def solve5(M, b):
    """x with M x = b for [N, 5, 5] systems near the identity (Gaussian
    elimination without pivoting, one elementwise operation at a time so
    that it runs in any dtype)."""
    a = [[M[:, i, j] for j in range(5)] for i in range(5)]
    r = [b[:, i] for i in range(5)]
    for k in range(5):
        for i in range(k + 1, 5):
            f = a[i][k] / a[k][k]
            for j in range(k, 5):
                a[i][j] = a[i][j] - f * a[k][j]
            r[i] = r[i] - f * r[k]
    x = [None] * 5
    for i in range(4, -1, -1):
        acc = r[i]
        for j in range(i + 1, 5):
            acc = acc - a[i][j] * x[j]
        x[i] = acc / a[i][i]
    return torch.stack(x, dim=1)


def step(st: dict, c: dict, fx, fy) -> dict:
    p = c["p"]
    s, x = st["s"], st["dyn_x"]
    h = p["t_s"]
    v_old = s[:, 3]
    a = clip(p["k_p_v"] * (torch.sqrt(fx * fx + fy * fy) - v_old),
             *p["a_max"])
    v_new = clip(v_old + h * a, *p["v_max_riding"])
    v_mid = (v_new + v_old) / 2.0
    psi_bike = x[:, 4]
    psi_c = psi_bike + angle_difference(psi_bike,
                                        limit_angle(torch.atan2(-fy, fx)))
    # gains recomputed where the speed changed, else the cached ones
    K = torch.where((v_new != v_old)[:, None], gains_poly(c, v_mid),
                    st["dyn_gains"][:, :5])
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
            "dyn_gains": torch.cat([K, st["dyn_gains"][:, 5:]], dim=1)}
