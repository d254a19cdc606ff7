"""Inverted-pendulum bicycle: lean and steer dynamics under speed-scheduled
full-state feedback, with a riding/walking FSM (counterpart of
`cyclistsocialforce_tpu.models.invpendulum`; reference
InvPendulumBicycle, vehicle.py:1651-1950, the BMD2023 "inverted pendulum
model").

Position and speed take a P-controlled Euler step; yaw, steer and roll
take one sample of the closed-loop 5-state system

    x = [delta, delta_dot, theta, theta_dot, psi],
    xdot = (A(v) - B K_x(v)) x + K_u(v) B psi_d,

held constant over the sample (the reference's `ct.forced_response` per
agent per step, vehicle.py:1835-1842). Three propagators give the
sample's Phi(v), Gamma(v): the exact one, expm([[Acl t_s, Bcl t_s], [0,
0]]) per agent (`ops.smallmat.expm_small` on [N, 6, 6]); the table of
`InvPendulumBicycleParams.create(zoh_lut=G)`, interpolated linearly; and
the piecewise quintic of `create(zoh_poly=S)` (`ops.piecewise`).

Below `v_max_walk` the rider walks: the bicycle2d kinematics at walking
speed with zero roll. The reference scans a 1 s steer-angle window per
step to allow the switch back to riding; a counter of consecutive steps
within `delta_max_walk` (`walk_ok_steps`) replaces it. Once the
navigation FSM latches "arrived", speed, steer and roll are zero and the
dynamics latents hold.

Every branch runs for every agent and `torch.where` keeps each agent's
own: no host read, no data-dependent shape.
"""

from __future__ import annotations

import math

import torch

from cyclistsocialforce_tpu_torch.models import bicycle2d
from cyclistsocialforce_tpu_torch.ops.piecewise import (coeff_matrix,
                                                        eval_piecewise_poly)
from cyclistsocialforce_tpu_torch.ops.smallmat import (expm_small,
                                                       matvec_small)
from cyclistsocialforce_tpu_torch.params import pair_hi, pair_lo
from cyclistsocialforce_tpu_torch.state import (DELTA, PSI, THETA, V, X, Y,
                                                AgentState)
from cyclistsocialforce_tpu_torch.utils.angles import limit_angle, thresh

N_STATES = 6
REP_FORCE = "twod"
DEST_FORCE = "spline"
STATE_WIDTHS = {"dyn_x": 5, "dyn_gains": 0, "zrid": 2}

WALK_OK_CAP = 1 << 20

# the parameters of the open-loop matrices
OPENLOOP_FIELDS = ("l", "l_2", "g", "tau_1_squared", "c_steer",
                   "i_steer_vertvert")


def _set(s, cols):
    """`s` with the columns of `cols` ({index: [N] tensor or number})
    replaced, in its dtype (out of place)."""
    out = s.clone()
    for k, val in cols.items():
        out[:, k] = val
    return out


def prepare(params, state: AgentState) -> AgentState:
    """Dynamics latents and the riding FSM from the CSF state (reference
    vehicle.py:1728-1736)."""
    s = state.s
    dyn_x = torch.zeros_like(state.dyn_x)
    dyn_x[:, 0] = s[:, DELTA]
    dyn_x[:, 2] = s[:, THETA]
    dyn_x[:, 4] = s[:, PSI]
    walking = s[:, V] < params.v_max_walk
    zrid = torch.stack([~walking, walking], dim=1)
    walk_ok = (torch.abs(s[:, DELTA]) < params.delta_max_walk).to(
        state.walk_ok_steps.dtype)
    return state.replace(dyn_x=dyn_x, zrid=zrid, walk_ok_steps=walk_ok)


def openloop_matrices(pb, v):
    """Open-loop A(v) [..., 5, 5] and B [..., 5] of the lean/steer/yaw
    system (reference vehicle.py:1738-1768). `pb` maps OPENLOOP_FIELDS to
    numbers or tensors shaped like v."""
    l, l_2, g = pb["l"], pb["l_2"], pb["g"]
    tau1sq = pb["tau_1_squared"]
    c_st, i_sv = pb["c_steer"], pb["i_steer_vertvert"]

    K = v * v / (g * l)
    K_tau_2 = v * l_2 / (g * l)
    inv_tau_3 = v / l          # 1 / (l / v); v == 0 -> 0 rate, like 1/inf

    A = torch.zeros(v.shape + (5, 5), dtype=v.dtype, device=v.device)
    A[..., 0, 1] = 1.0
    A[..., 1, 1] = -c_st / i_sv
    A[..., 2, 3] = 1.0
    A[..., 3, 0] = -K / tau1sq
    A[..., 3, 1] = -K_tau_2 / tau1sq
    A[..., 3, 2] = 1.0 / tau1sq
    A[..., 4, 0] = inv_tau_3
    B = torch.zeros(v.shape + (5,), dtype=v.dtype, device=v.device)
    B[..., 1] = 1.0 / i_sv
    return A, B


def zoh_augmented(params, pb, v, t_s):
    """[..., 6, 6] matrices [[Acl(v) t_s, K_u(v) B t_s], [0, 0]] of the
    closed loop at speeds v, whose exponential's first five rows are the
    sample's (Phi, Gamma)."""
    K_x, K_u = params.fullstate_feedback_gains(v)
    A, B = openloop_matrices(pb, v)
    aug = torch.zeros(v.shape + (6, 6), dtype=v.dtype, device=v.device)
    aug[..., :5, :5] = A - B[..., :, None] * K_x[..., None, :]
    aug[..., :5, 5] = K_u[..., None] * B
    return aug * (t_s[..., None, None] if isinstance(t_s, torch.Tensor)
                  else t_s)


def _riding_exact(params, v, x5, psi_d, t_s):
    """One exact ZOH sample of every agent's closed loop (the JAX
    package's `_step_yaw_one`, batched)."""
    pb = {f: getattr(params, f) for f in OPENLOOP_FIELDS}
    e = expm_small(zoh_augmented(params, pb, v, t_s))
    return matvec_small(e[..., :5, :5], x5) + e[..., :5, 5] * psi_d[:, None]


def _riding_lut(params, v, x5, psi_d):
    """Phi(v), Gamma(v) interpolated linearly in the `ip_zoh_lut` table."""
    tab, v0, dv = params.ip_zoh_lut
    tab = tab.to(dtype=v.dtype, device=v.device)
    g = tab.shape[0]
    t = torch.clamp((v - v0) / dv, 0.0, g - 1.0)
    i0 = torch.clamp(torch.floor(t).long(), 0, g - 2)
    w = (t - i0.to(t.dtype))[:, None]
    E = tab[i0] * (1.0 - w) + tab[i0 + 1] * w              # [N, 30]
    Phi = E[:, :25].reshape(-1, 5, 5)
    return torch.sum(Phi * x5[:, None, :], dim=2) + E[:, 25:] * psi_d[:, None]


def _riding_poly(params, v, x5, psi_d, coeffs):
    """Phi(v), Gamma(v) from the `ip_zoh_poly` piecewise quintic; entry
    5 i + j is Phi[i, j], 25 + i is Gamma[i]."""
    cols = eval_piecewise_poly(params.ip_zoh_poly, v, 30, coeffs)
    return torch.stack(
        [sum(cols[5 * i + j] * x5[:, j] for j in range(5))
         + cols[25 + i] * psi_d for i in range(5)], dim=1)


def step_constants(params, dtype, device) -> dict:
    """The device tensors `step` reads that no step changes, as its
    keywords: the `ip_zoh_poly` coefficient matrix. An engine builds them
    once per dtype and device and keeps them as long as its captured
    chunks, which read them by address (`Engine.kept_constants`)."""
    poly = getattr(params, "ip_zoh_poly", None)
    if poly is None:
        return {}
    return {"poly_coeffs": coeff_matrix(poly, dtype, device)}


def step(params, state: AgentState, fx, fy, poly_coeffs=None) -> AgentState:
    """One inverted-pendulum step (reference vehicle.py:1883-1930).
    `poly_coeffs`: see `step_constants` (built in the step when None)."""
    s = state.s
    t_s = params.t_s
    vmw, dmw = params.v_max_walk, params.delta_max_walk

    # ---- riding/walking FSM (reference vehicle.py:1932-1950)
    cvwalk = s[:, V] < vmw
    if isinstance(t_s, torch.Tensor):
        window = torch.minimum(state.i + 1, torch.floor(1.0 / t_s).to(
            state.i.dtype) + 1)
    else:
        window = torch.clamp(state.i + 1, max=math.floor(1.0 / t_s) + 1)
    cdelta = state.walk_ok_steps >= window
    riding = (~cvwalk) & ((state.zrid[:, 1] & cdelta) | state.zrid[:, 0])
    zrid = torch.stack([riding, ~riding], dim=1)
    arrived = state.znav[:, 2]

    # ---- riding branch: step_pos (vehicle.py:1850-1881)
    vd = torch.sqrt(fx**2 + fy**2)
    a = params.k_p_v * (vd - s[:, V])
    a = thresh(a, (pair_lo(params.a_max), pair_hi(params.a_max)))
    v_new = thresh(s[:, V] + t_s * a, (pair_lo(params.v_max_riding),
                                       pair_hi(params.v_max_riding)))
    x_pos = s[:, X] + t_s * v_new * torch.cos(s[:, PSI])
    y_pos = s[:, Y] + t_s * v_new * torch.sin(s[:, PSI])

    # step_yaw (vehicle.py:1810-1848) at the new speed
    psi_d = torch.atan2(fy, fx)
    x5 = state.dyn_x[:, :5]
    if getattr(params, "ip_zoh_poly", None) is not None:
        dyn_riding = _riding_poly(params, v_new, x5, psi_d, poly_coeffs)
    elif getattr(params, "ip_zoh_lut", None) is not None:
        dyn_riding = _riding_lut(params, v_new, x5, psi_d)
    else:
        dyn_riding = _riding_exact(params, v_new, x5, psi_d, t_s)
    dyn_riding = dyn_riding.to(s.dtype)

    s_riding = _set(s, {X: x_pos, Y: y_pos, V: v_new,
                        PSI: limit_angle(dyn_riding[:, 4]),
                        DELTA: limit_angle(dyn_riding[:, 0]),
                        THETA: limit_angle(dyn_riding[:, 2])})

    # ---- walking branch (vehicle.py:1904-1916): 2D kinematics at
    # v = v_max_walk with zero roll
    s_w_pre = _set(s, {V: vmw, THETA: 0.0})
    a_w, odelta_w, pid_e_w, pid_i_w = bicycle2d.control(
        params, state.replace(s=s_w_pre), fx, fy)
    s_walk = bicycle2d.move(params, s_w_pre, a_w, odelta_w).to(s.dtype)
    dyn_walk = torch.zeros_like(dyn_riding)
    dyn_walk[:, 0] = s_walk[:, DELTA]
    dyn_walk[:, 2] = s_walk[:, THETA]
    dyn_walk[:, 4] = s_walk[:, PSI]

    # ---- arrived: freeze v, delta, theta (vehicle.py:1898-1899)
    s_arr = _set(s, {V: 0.0, DELTA: 0.0, THETA: 0.0})

    rid = riding[:, None]
    arr = arrived[:, None]
    s_new = torch.where(arr, s_arr, torch.where(rid, s_riding, s_walk))
    dyn5 = torch.where(arr, x5, torch.where(rid, dyn_riding, dyn_walk))
    dyn_x = torch.cat([dyn5, state.dyn_x[:, 5:]], dim=1)
    walking_active = ((~arrived) & ~riding)[:, None]
    pid_e = torch.where(walking_active, pid_e_w.to(s.dtype), state.pid_e)
    pid_i = torch.where(walking_active, pid_i_w.to(s.dtype), state.pid_i)

    # ---- steer-window counter for the next FSM transition
    ok = torch.abs(s_new[:, DELTA]) < dmw
    walk_ok = torch.where(
        ok, torch.clamp(state.walk_ok_steps + 1, max=WALK_OK_CAP),
        torch.zeros_like(state.walk_ok_steps))

    return state.replace(s=s_new, dyn_x=dyn_x, pid_e=pid_e, pid_i=pid_i,
                         zrid=zrid, walk_ok_steps=walk_ok)
