"""bicycle2d: the kinematic bicycle with P-controlled steer and speed
loops (upstream cyclistsocialforce's `Bicycle`)."""

import torch

from ..step import _norm, angle_difference, clip, limit_angle


def constants(cfg: dict, dtype, device) -> dict:
    return {}


def initial(st: dict, c: dict) -> dict:
    return {}


def step(st: dict, c: dict, fx, fy) -> dict:
    p = c["p"]
    s = st["s"]
    t_s = p["t_s"]
    theta = torch.atan2(fy, fx)
    v_cmd = torch.sqrt(fx * fx + fy * fy)
    ddest = _norm(st["dest"][:, :2] - s[:, :2])
    last = st["destpointer"] + 1 >= st["nq"]
    v_cmd = torch.where((ddest < 3.0) & last, v_cmd / 3.0 * ddest, v_cmd)
    ddelta = angle_difference(s[:, 4], angle_difference(s[:, 2], theta))
    dv = v_cmd - s[:, 3]
    # P loops (no integral or derivative gain): out = kp e + i
    odelta = p["k_p_delta"] * ddelta + st["pid_i"][:, 0]
    a = p["k_p_v"] * dv + st["pid_i"][:, 1]
    a = clip(a, *p["a_max"])
    delta = limit_angle(s[:, 4] + t_s * odelta)
    v = clip(s[:, 3] + t_s * a, *p["v_max_riding"])
    delta = clip(delta, -p["delta_max"], p["delta_max"])
    psi = limit_angle(s[:, 2] + t_s * v * torch.tan(delta) / p["l"])
    y = s[:, 1] + t_s * v * torch.sin(psi)
    x = s[:, 0] + t_s * v * torch.cos(psi)
    s_new = torch.cat([torch.stack([x, y, psi, v, delta], dim=1), s[:, 5:]],
                      dim=1)
    return {"s": s_new, "pid_e": torch.stack([ddelta, dv], dim=1)}
