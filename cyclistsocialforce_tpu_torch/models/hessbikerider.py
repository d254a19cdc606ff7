"""Hess et al. (2012) human-control bicycle: the Whipple-Carvallo plant
under a fixed-gain neuromuscular steer-torque loop (counterpart of
`cyclistsocialforce_tpu.models.hessbikerider`; reference
HessBikeRiderDynamics, dynamics.py:708-799). The 5-state Whipple+yaw
plant is driven through a 2nd-order neuromuscular actuator (states
T_delta, dT_delta) and closed with the gain curves of Moore (2012)
(reference `get_adaptive_gains`, dynamics.py:727-739): a 7-state closed
loop

    x = [phi, delta, phidot, deltadot, psi, T_delta, dT_delta],
    xdot = A(v) x + B psi_c,

with the commanded yaw psi_c as input, propagated by the implicit
midpoint rule (one batched 7x7 `ops.smallmat.solve_small`, pivoted), the
speed and positions as the balancing rider's. Upstream the model cannot
run (its inherited step indexes a 1-column input matrix, dynamics.py:612);
this is the behavior the JAX package implements, held there to a
control-theory oracle. Stable for v >~ 4.5 m/s with the shipped
balance-assist parameters.
"""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.models.balancingrider import (_MATRICES,
                                                                _const,
                                                                _per_rider,
                                                                _system)
from cyclistsocialforce_tpu_torch.ops.smallmat import (matvec_small,
                                                       solve_small)
from cyclistsocialforce_tpu_torch.params import (HessBikeRiderParams,
                                                 pair_hi, pair_lo)
from cyclistsocialforce_tpu_torch.state import (DDELTA, DELTA, DTHETA, PSI,
                                                THETA, V, X, Y, AgentState)
from cyclistsocialforce_tpu_torch.utils.angles import (angle_difference,
                                                       limit_angle, thresh)

N_STATES = 8
REP_FORCE = "twod"
DEST_FORCE = "direct"
STATE_WIDTHS = {"dyn_x": 7, "dyn_gains": 0, "zrid": 0}

# the control-loop gain fields of HessBikeRiderParams
GAIN_FIELDS = ("k_delta", "k_phi", "k_dphi", "k_psi", "omega", "zeta")


def step_constants(params, dtype, device) -> dict:
    """The plant's A0, A1, A2, B as tensors of `dtype` on `device` (the
    `constants` keyword of `step`; see `balancingrider.step_constants`)."""
    return {"constants": {key: _const(getattr(params, f), dtype, device)
                          for key, f in _MATRICES}}


def prepare(params, state: AgentState) -> AgentState:
    """Bike-frame latents [phi, -delta, phidot, -deltadot, -psi, T, dT]
    (the balancing rider's frame flips, dynamics.py:361-399; the
    neuromuscular torque states start at zero, dynamics.py:724-725)."""
    s = state.s
    zero = torch.zeros_like(s[:, 0])
    dyn_x = torch.stack([
        s[:, THETA], -s[:, DELTA], s[:, DTHETA], -s[:, DDELTA],
        -s[:, PSI], zero, zero], dim=1)
    return state.replace(dyn_x=dyn_x, dyn_v=s[:, V].clone())


def hess_A_B(params, v, constants=None):
    """Closed-loop A(v) [N, 7, 7] and input column B [N, 7] at speeds v
    [N], with each rider's gains (numbers, or [N] tensors per rider)."""
    c = constants or step_constants(params, v.dtype, v.device)["constants"]
    n = v.shape[0]
    kd, kphi, kdphi, kpsi, om, ze = (_per_rider(getattr(params, f), v)
                                     for f in GAIN_FIELDS)
    om2 = om * om
    zero = torch.zeros_like(v)
    A = torch.zeros((n, 7, 7), dtype=v.dtype, device=v.device)
    A[:, 0:5, 0:5] = _system(c, v)
    A[:, 0:5, 5] = c["B"]
    A[:, 5, 6] = 1.0
    row = [-kd * kphi * kdphi * om2, -kd * om2, -kd * kdphi * om2, zero,
           -kd * kphi * kdphi * kpsi * om2, -om2, -2.0 * om * ze]
    A[:, 6, :] = torch.stack([r + zero for r in row], dim=1)
    B = torch.zeros((n, 7), dtype=v.dtype, device=v.device)
    B[:, 6] = kd * kphi * kdphi * kpsi * om2
    return A, B


def step(params, state: AgentState, fx, fy, constants=None) -> AgentState:
    """One Hess bike-rider step: speed P-control, the closed-form implicit
    midpoint of the linear 7-state loop, the explicit position rows.
    `constants`: see `step_constants` (built here when None)."""
    s = state.s
    h = _per_rider(params.t_s, s)
    a_max, v_max = params.a_max, params.v_max_riding
    v_old = s[:, V]
    vd = torch.sqrt(fx * fx + fy * fy)
    a = _per_rider(params.k_p_v, s) * (vd - v_old)
    a = thresh(a, (_per_rider(pair_lo(a_max), s),
                   _per_rider(pair_hi(a_max), s)))
    v_new = thresh(v_old + h * a, (_per_rider(pair_lo(v_max), s),
                                   _per_rider(pair_hi(v_max), s)))
    v_mid = (v_new + v_old) / 2.0

    psi_bike = state.dyn_x[:, 4]
    psi_F = limit_angle(torch.atan2(-fy, fx))
    psi_c = psi_bike + angle_difference(psi_bike, psi_F)

    A, B = hess_A_B(params, v_mid, constants)
    x7 = state.dyn_x
    h1, h2 = ((h[:, None], h[:, None, None]) if isinstance(h, torch.Tensor)
              else (h, h))
    rhs = x7 + (h1 / 2.0) * matvec_small(A, x7) + h1 * B * psi_c[:, None]
    eye = torch.eye(7, dtype=s.dtype, device=s.device)
    x_next = solve_small(eye - (h2 / 2.0) * A, rhs)
    psi_mid = (x7[:, 4] + x_next[:, 4]) / 2.0
    px = s[:, X] + h * v_mid * torch.cos(psi_mid)
    py = -s[:, Y] + h * v_mid * torch.sin(psi_mid)

    s_new = torch.stack([
        px, -py, -limit_angle(x_next[:, 4]), v_new,
        -limit_angle(x_next[:, 1]), limit_angle(x_next[:, 0]),
        -x_next[:, 3], x_next[:, 2]], dim=1)
    return state.replace(s=s_new, dyn_x=x_next, dyn_v=v_new)


__all__ = ["DEST_FORCE", "GAIN_FIELDS", "HessBikeRiderParams", "N_STATES",
           "REP_FORCE", "STATE_WIDTHS", "hess_A_B", "prepare", "step",
           "step_constants"]
