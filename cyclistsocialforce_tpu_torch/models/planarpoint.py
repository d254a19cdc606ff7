"""Mass-less planar point bicycle with first-order yaw tracking
(counterpart of `cyclistsocialforce_tpu.models.planarpoint`; reference
PlanarPointBicycle + PlanarPointDynamics, vehicle.py:1991-2028,
dynamics.py:802-1079).

    psi_dot = -k_psi (psi - psi_c),  x_dot = v cos psi,  y_dot = v sin psi

The reference solves the implicit-midpoint residual of these equations per
agent per step with a Levenberg-Marquardt root finder (dynamics.py:
1055-1062). The system is lower-triangular: the midpoint equation for psi
is linear and the position rows are then explicit, so the exact midpoint
solution is closed-form, and that is the step here (as in the JAX
package). Speed: P-controlled acceleration with the a_max / v_max_riding
clamps (dynamics.py:1000-1036). The latents dyn_x = [psi unwrapped, x, y]
and dyn_v mirror the reference's Dynamics state: yaw accumulates
unwrapped, the vehicle state gets the wrapped angle.
"""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.params import pair_hi, pair_lo
from cyclistsocialforce_tpu_torch.state import PSI, V, X, Y, AgentState
from cyclistsocialforce_tpu_torch.utils.angles import limit_angle, thresh

N_STATES = 4
REP_FORCE = "twod"     # PlanarPointBicycle borrows TwoDBicycle's forces
DEST_FORCE = "spline"  # (reference vehicle.py:2022-2024)
STATE_WIDTHS = {"dyn_x": 3, "dyn_gains": 0, "zrid": 0}


def yaw_gain(params):
    """k_psi: the first pole's -Re where there are poles (they overwrite
    the gains, reference dynamics.py:831-853, 948-956), else the first
    gain; a number for a shared set, an [N] tensor per rider."""
    poles = getattr(params, "poles", None)
    if poles is not None:
        if isinstance(poles, torch.Tensor):
            return -poles[..., 0].real
        return -complex(poles[0]).real
    gains = params.gains
    return gains[..., 0] if isinstance(gains, torch.Tensor) else gains[0]


def prepare(params, state: AgentState) -> AgentState:
    """The dynamics latents from the CSF state (reference dynamics.py:827,
    _transform_state_csf2dynamics)."""
    dyn_x = state.dyn_x.clone()
    dyn_x[:, 0] = state.s[:, PSI]
    dyn_x[:, 1] = state.s[:, X]
    dyn_x[:, 2] = state.s[:, Y]
    return state.replace(dyn_x=dyn_x, dyn_v=state.s[:, V].clone())


def step(params, state: AgentState, fx, fy) -> AgentState:
    """One speed and exact-midpoint lateral step (reference
    dynamics.py:1041-1079)."""
    t_s = params.t_s
    s = state.s

    # speed: P control, acceleration and speed clamps
    vd = torch.sqrt(fx**2 + fy**2)
    a = params.k_p_v * (vd - state.dyn_v)
    a = thresh(a, (pair_lo(params.a_max), pair_hi(params.a_max)))
    v_new = thresh(state.dyn_v + t_s * a, (pair_lo(params.v_max_riding),
                                           pair_hi(params.v_max_riding)))
    # midpoint speed: the new dynamics speed and the CSF state's speed
    # (reference dynamics.py:1056: (v + vehicle.s[3]) / 2)
    v_mid = (v_new + s[:, V]) / 2

    # commanded yaw (reference dynamics.py:116-125)
    psi_c = limit_angle(torch.atan2(fy, fx))

    # exact implicit-midpoint solution of the triangular system
    hk2 = t_s * yaw_gain(params) / 2
    psi = state.dyn_x[:, 0]
    psi_next = ((1 - hk2) * psi + 2 * hk2 * psi_c) / (1 + hk2)
    psi_mid = (psi + psi_next) / 2
    x_next = state.dyn_x[:, 1] + t_s * v_mid * torch.cos(psi_mid)
    y_next = state.dyn_x[:, 2] + t_s * v_mid * torch.sin(psi_mid)

    dyn_x = state.dyn_x.clone()
    dyn_x[:, 0] = psi_next
    dyn_x[:, 1] = x_next
    dyn_x[:, 2] = y_next
    s_new = s.clone()
    s_new[:, X] = x_next
    s_new[:, Y] = y_next
    s_new[:, PSI] = limit_angle(psi_next)
    s_new[:, V] = v_new
    return state.replace(s=s_new, dyn_x=dyn_x,
                         dyn_v=v_new.to(state.dyn_v.dtype))
