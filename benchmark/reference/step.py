"""The plain reference of the two configurations' step, in any float dtype
(float64 for the check, bfloat16 for its control).

It follows upstream cyclistsocialforce's semantics as the configuration
file states them: the destination queue and the navigation FSM, the
destination force the configuration names (`dest_force`: the straight
line here, or `dest_<name>.py`'s, as the spline's in `dest_spline.py`),
the BMD2023 "twod" repulsive field in its published form (trigonometry
and all, not the port's half-angle algebra) summed over every rider
within the configuration's cutoff and inside the receiver's field of
view, clamped to the destination force's magnitude, then one step of
the model's dynamics (`models/<model>.py`), and the
bookkeeping (inactive riders frozen, step counters, the position ring
where the state has one). Rows keep their order: there is no table and
no permutation. Nothing here imports the program or JAX.

A state is a dict of tensors: s [N, 8] (x, y, yaw, speed, steer, roll,
steer rate, roll rate), dyn_x [N, 7] and dyn_gains [N, 12] (balancing
rider), pid_e, pid_i [N, 2], dest [N, 3], destqueue [N, Q, 3],
destpointer, nq, i [N] int, znav [N, 3] bool, znavparams [N, 4],
active [N] bool, and the fields the model's module names in its
`EXTRA_FIELDS` (twod: pos_hist [N, H, 2], slot t % H the positions at
global step t, and t_glob, the 0-d global step; the stochastic balancing
rider: key, uid and t_glob, its random streams'). The model's module is
the configuration's `reference_model`, by default its `model`
(`reference_model`).
"""

from __future__ import annotations

import importlib
import math

import torch

from . import grid

TWO_PI = 2.0 * math.pi
BRAKE_SAFETY_K = 1.5
FLOAT_KEYS = ("s", "dyn_x", "dyn_gains", "pid_e", "pid_i", "dest",
              "destqueue", "znavparams", "pos_hist")


# ---- angles ---------------------------------------------------------------

def limit_angle(t):
    t = t - torch.floor(t / TWO_PI) * TWO_PI
    t = torch.where(t > math.pi, t - TWO_PI, t)
    return torch.where(t < -math.pi, t + TWO_PI, t)


def angle_difference(a1, a2):
    """The signed smallest rotation taking a1 onto a2."""
    da = torch.abs(a1 - a2)
    da = torch.where(da > math.pi, TWO_PI - da, da)
    t1 = torch.abs(limit_angle(a1 - da) - a2)
    t2 = torch.abs(limit_angle(a1 + da) - a2)
    return torch.where(t1 < t2, -da, da)


def clip(x, lo, hi):
    return torch.clamp(torch.clamp(x, max=hi), min=lo)


# ---- set-up ---------------------------------------------------------------

def reference_model(cfg: dict) -> str:
    """The name of the reference's module of configuration `cfg`'s model:
    its `reference_model` where the program's model name alone does not
    say what the reference steps, else its `model`."""
    return cfg.get("reference_model", cfg["model"])


def model_of(name: str):
    """The reference's module of model `name` (`models/<name>.py`): its
    `constants`, `initial` and `step`, and optionally `EXTRA_FIELDS`."""
    return importlib.import_module(f"{__package__}.models.{name}")


def extra_fields(model: str) -> tuple:
    """The state fields that model `model` reads besides the common ones
    (its module's `EXTRA_FIELDS`; none by default)."""
    return tuple(getattr(model_of(model), "EXTRA_FIELDS", ()))


def dest_force_of(name: str):
    """The destination force named by a configuration's `dest_force`:
    `destination` for the straight line ("straight", "direct"), else
    `dest_<name>.py`'s `destination`. Each takes (state, parameters) and
    returns (fx, fy, the updated fields)."""
    if name in ("straight", "direct"):
        return destination
    return importlib.import_module(f"{__package__}.dest_{name}").destination


def constants(cfg: dict, dtype, device) -> dict:
    """What the configuration derives before the first step: the
    parameters, the cutoff, and what the model's own `constants` works
    out."""
    c = {"p": dict(cfg["params"]), "cutoff": float(cfg["neighbors"]["cutoff"]),
         "model": reference_model(cfg), "dest_force": cfg["dest_force"]}
    c.update(model_of(c["model"]).constants(cfg, dtype, device))
    return c


def initial_state(cfg: dict, c: dict, s0, dest, n_riders: int, dtype,
                  device, waypoints=None) -> dict:
    """The state before the first step, from the generated inputs (s0
    [rows, 5], dest [rows, 2], float64 numpy). `waypoints` [rows, K, 2],
    where the traffic has them, fill the first K queue slots (nq = K, the
    pointer at the first). A model with a position ring starts it as
    `make_state` does: every slot the initial position."""
    rows = s0.shape[0]
    q = int(cfg.get("queue_size", 16))
    s = torch.zeros((rows, 8), dtype=torch.float64, device=device)
    s[:, :5] = torch.as_tensor(s0, dtype=torch.float64, device=device)
    s[:, 2] = limit_angle(s[:, 2])
    d = torch.zeros((rows, 3), dtype=torch.float64, device=device)
    d[:, :2] = torch.as_tensor(dest, dtype=torch.float64, device=device)
    queue = torch.zeros((rows, q, 3), dtype=torch.float64, device=device)
    queue[:, 0] = d
    nq = torch.ones(rows, dtype=torch.int32, device=device)
    if waypoints is not None:
        k = waypoints.shape[1]
        queue[:, :k, :2] = torch.as_tensor(waypoints, dtype=torch.float64,
                                           device=device)
        d = queue[:, 0].clone()
        nq.fill_(k)
    st = {
        "s": s, "pid_e": torch.zeros((rows, 2), dtype=torch.float64,
                                     device=device),
        "dest": d, "destqueue": queue,
        "destpointer": torch.zeros(rows, dtype=torch.int32, device=device),
        "nq": nq,
        "i": torch.zeros(rows, dtype=torch.int32, device=device),
        "znav": torch.zeros((rows, 3), dtype=torch.bool, device=device),
        "znavparams": torch.zeros((rows, 4), dtype=torch.float64,
                                  device=device),
        "active": torch.arange(rows, device=device) < n_riders,
    }
    st["pid_i"] = st["pid_e"].clone()
    st["znav"][:, 0] = True
    if "pos_hist" in extra_fields(c["model"]):
        st["pos_hist"] = s[:, None, :2].expand(
            rows, int(cfg["hist_len"]), 2).clone()
        st["t_glob"] = torch.zeros((), dtype=torch.int32, device=device)
    st.update(model_of(c["model"]).initial(st, c))
    return cast(st, dtype)


def cast(st: dict, dtype) -> dict:
    return {k: (v.to(dtype) if k in FLOAT_KEYS else v) for k, v in st.items()}


# ---- one step -------------------------------------------------------------

def _take(queue, idx):
    return torch.gather(queue, 1,
                        idx.long()[:, None, None].expand(-1, 1, 3))[:, 0]


def _norm(d):
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])


def navigate(st: dict, p: dict):
    """Queue update and navigation FSM: (the desired speed, the distance
    to the destination, the updated fields)."""
    pos, dest, queue = st["s"][:, :2], st["dest"], st["destqueue"]
    ptr0, nq, znav, i = st["destpointer"], st["nq"], st["znav"], st["i"]
    dnext = _norm(_take(queue, ptr0)[:, :2] - pos)
    skip = znav[:, 1] | znav[:, 2]
    adv = dnext <= p["d_arrived_inter"]
    ptr = torch.where(adv, torch.minimum(ptr0 + 1, nq - 1), ptr0)
    has_next = ptr < nq - 1
    nxt = torch.clamp(ptr + 1, 0, queue.shape[1] - 1)
    dnn = _norm(_take(queue, nxt)[:, :2] - pos)
    ptr = torch.where(has_next & (dnn < dnext), ptr + 1, ptr)
    ptr = torch.where(skip, ptr0, ptr)
    dest = torch.where(skip[:, None], dest, _take(queue, ptr))
    ddest = _norm(_take(queue, ptr)[:, :2] - pos)

    v = st["s"][:, 3]
    zp = st["znavparams"]
    vh = p["v_max_harddecel"]
    k = BRAKE_SAFETY_K
    d0 = torch.where(znav[:, 0],
                     0.5 * (vh * vh - v * v) / p["a_desired_default"][0],
                     zp[:, 1])
    d1 = torch.where(znav[:, 0],
                     torch.full_like(v, 0.5 * (-(vh * vh)) / p["a_max"][0]),
                     zp[:, 2])
    x0 = dest[:, 2] > 0
    x1 = ddest <= k * (d0 + d1)
    x2 = ddest <= p["d_arrived_stop"]
    x3 = v <= p["v_max_stop"]
    z0, z1, z2 = znav[:, 0], znav[:, 1], znav[:, 2]
    n0 = (~x0) | (x0 & (~x1) & ((z0 & ~x2) | z1))
    n1 = x0 & ((z0 & (((~x2) & x1) | (x2 & ~x3)))
               | (z1 & x1 & ((~x2) | (~x3))))
    n2 = x0 & (((z0 | z1) & x2 & x3) | z2)
    latch = z0 & n1
    zp = torch.where(latch[:, None],
                     torch.stack([v, d0, d1, i.to(v.dtype)], dim=1), zp)
    d0s = torch.where(zp[:, 1] != 0, zp[:, 1], 1.0)
    d1s = torch.where(zp[:, 2] != 0, zp[:, 2], 1.0)
    vd_near = vh / d1s * ddest / k
    vd_far = (zp[:, 0] - vh) / d0s * (ddest - zp[:, 2]) / k + vh
    vd = torch.where(n1, torch.where(ddest < k * zp[:, 2], vd_near, vd_far),
                     torch.zeros_like(v))
    vd = torch.where(n0, torch.full_like(v, p["v_desired_default"]), vd)
    upd = {"dest": dest, "destpointer": ptr, "znavparams": zp,
           "znav": torch.stack([n0, n1, n2], dim=1)}
    return vd, ddest, upd


def destination(st: dict, p: dict):
    """Queue update, navigation FSM and straight-line force: (fx, fy, the
    updated fields)."""
    vd, ddest, upd = navigate(st, p)
    pos, dest = st["s"][:, :2], upd["dest"]
    ok = ddest > 0
    safe = torch.where(ok, ddest, 1.0)
    fx = torch.where(ok, -vd * (pos[:, 0] - dest[:, 0]) / safe, 0.0)
    fy = torch.where(ok, -vd * (pos[:, 1] - dest[:, 1]) / safe, 0.0)
    return fx, fy, upd


def repulsion(st: dict, p: dict, cutoff: float):
    """The twod field summed at every active receiver over the active
    sources within `cutoff` that lie inside its field of view."""
    s, act = st["s"], st["active"]
    x, y, psi = s[:, 0], s[:, 1], s[:, 2]
    cos_p, sin_p = torch.cos(psi), torch.sin(psi)
    frx, fry = torch.zeros_like(x), torch.zeros_like(x)
    cos_half_fov = math.cos(p["hfov"] / 2)
    for r, c in grid.pairs_within(x, y, cutoff, act):
        dx, dy = x[r] - x[c], y[r] - y[c]          # receiver - source
        cs, ss, cr, sr = cos_p[c], sin_p[c], cos_p[r], sin_p[r]
        sin_rel = ss * cr - cs * sr
        sin2 = sin_rel * sin_rel
        vdecay0 = p["sigma_0"] + p["sigma_1"] * sin2
        vdecay1 = p["sigma_2"] + p["sigma_3"] * sin2
        e = p["e_0"] - p["e_1"] * sin2
        rho = torch.sqrt(dx * dx + dy * dy)
        apart = rho > 0
        rho = torch.where(apart, rho, 1.0)
        cosphi = torch.clamp((dx * cs + dy * ss) / rho, -1.0, 1.0)
        sinphi = (dy * cs - dx * ss) / rho
        sigma = vdecay0 - vdecay1 * torch.sqrt((1 - cosphi) / 2)
        dsigm = (-vdecay1 * torch.sqrt((1 + cosphi) / 2)
                 * torch.sign(sinphi) / 2)
        ec2 = 1 - (e * cosphi) ** 2
        sq = torch.sqrt(ec2)
        P = p["f_0"] * torch.exp(-rho * sq / sigma)
        frho = P * sq / sigma
        fphi = (-P * (ec2 * dsigm - e ** 2 * sinphi * cosphi * sigma)
                / (sigma ** 2 * sq))
        fmag = torch.sqrt(frho * frho + fphi * fphi)
        scale = P / (torch.where(fmag > 0, fmag, 1.0) * rho)
        # the source is seen where it lies inside the receiver's half
        # field of view
        seen = apart & ((-dx * cr - dy * sr) / rho >= cos_half_fov)
        frx.index_add_(0, r, torch.where(seen, scale * (frho * dx - fphi * dy),
                                         0.0))
        fry.index_add_(0, r, torch.where(seen, scale * (frho * dy + fphi * dx),
                                         0.0))
    return frx, fry


def clamp_add(frx, fry, fdx, fdy):
    """The repulsion clamped to the destination force's magnitude, plus
    the destination force."""
    limit = torch.sqrt(fdx * fdx + fdy * fdy)
    mag = torch.sqrt(frx * frx + fry * fry)
    scale = torch.where(mag > limit, limit / torch.where(mag > 0, mag, 1.0),
                        1.0)
    return frx * scale + fdx, fry * scale + fdy


def write_ring(st: dict, t1) -> torch.Tensor:
    """The position ring with slot t1 % H (t1 the global step after this
    one) set to the state's positions (every row: an inactive one holds
    its position)."""
    slot = torch.remainder(t1, st["pos_hist"].shape[1]).long().reshape(1)
    return st["pos_hist"].index_copy(1, slot, st["s"][:, None, :2])


def step(st: dict, c: dict) -> dict:
    p = c["p"]
    fdx, fdy, upd = dest_force_of(c["dest_force"])(st, p)
    frx, fry = repulsion(st, p, c["cutoff"])
    fx, fy = clamp_add(frx, fry, fdx, fdy)
    upd.update(model_of(c["model"]).step({**st, **upd}, c, fx, fy))
    act = st["active"]
    new = dict(st)
    for key, val in upd.items():
        mask = act.reshape((-1,) + (1,) * (val.ndim - 1))
        new[key] = torch.where(mask, val, st[key])
    new["i"] = st["i"] + act.to(st["i"].dtype)
    # the global step advances once a step wherever the state keeps it;
    # the ring, where there is one, takes the slot of the step after
    if "t_glob" in st:
        t1 = st["t_glob"] + 1
        if "pos_hist" in st:
            new["pos_hist"] = write_ring(new, t1)
        new["t_glob"] = t1
    return new


def run(st: dict, c: dict, steps: int) -> dict:
    for _ in range(steps):
        st = step(st, c)
    return st

