"""2D kinematic two-wheeler with P-controlled steer and speed loops
(counterpart of `cyclistsocialforce_tpu.models.bicycle2d`; reference
v0.1 `Bicycle`, vehicle.py:990-1289). Elementwise over the agent axis."""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.ops import agent_step as AS
from cyclistsocialforce_tpu_torch.ops.control import pid_step
from cyclistsocialforce_tpu_torch.params import pair_hi, pair_lo
from cyclistsocialforce_tpu_torch.state import DELTA, PSI, V, X, Y, AgentState
from cyclistsocialforce_tpu_torch.utils.angles import (
    angle_difference,
    limit_angle,
    thresh,
)

N_STATES = 5
# the reference Bicycle's default field is the legacy elliptic one; the
# port serves the "twod" field only, so engines pass rep_force="twod"
REP_FORCE = "legacy"
DEST_FORCE = "straight"
STATE_WIDTHS = {"dyn_x": 0, "dyn_gains": 0, "zrid": 0}


def agent_kernels(params) -> AS.AgentKernels:
    """The per-agent kernels of a step (`ops.agent_step`): agent_pre with
    the straight destination force, then agent_post, the twod or legacy
    field culled between them."""
    return AS.AgentKernels("straight", "agent_post", AS.MODEL_FIELDS,
                           ("twod", "legacy"))


def control(params, state: AgentState, fx, fy):
    """Bicycle.control (reference vehicle.py:1218-1245). Returns
    (a, odelta, pid_e, pid_i)."""
    theta = torch.atan2(fy, fx)
    v_cmd = torch.sqrt(fx * fx + fy * fy)

    ddx = state.dest[:, 0] - state.s[:, X]
    ddy = state.dest[:, 1] - state.s[:, Y]
    ddest = torch.sqrt(ddx * ddx + ddy * ddy)
    is_last = state.destpointer + 1 >= state.nq
    v_cmd = torch.where((ddest < 3.0) & is_last, v_cmd / 3.0 * ddest, v_cmd)

    target_angle_ego = angle_difference(state.s[:, PSI], theta)
    ddelta = angle_difference(state.s[:, DELTA], target_angle_ego)
    dv = v_cmd - state.s[:, V]

    zero = torch.zeros_like(ddelta)
    odelta, e0, i0 = pid_step(ddelta, state.pid_e[:, 0], state.pid_i[:, 0],
                              params.k_p_delta, zero, zero, params.t_s)
    a, e1, i1 = pid_step(dv, state.pid_e[:, 1], state.pid_i[:, 1],
                         params.k_p_v, zero, zero, params.t_s)
    return (a, odelta, torch.stack([e0, e1], dim=1),
            torch.stack([i0, i1], dim=1))


def move(params, s, a, odelta):
    """Bicycle.move kinematics (reference vehicle.py:1247-1272); returns
    the new [N, 8] state rows."""
    t_s = params.t_s
    a = thresh(a, (pair_lo(params.a_max), pair_hi(params.a_max)))
    delta = limit_angle(s[:, DELTA] + t_s * odelta)
    v = s[:, V] + t_s * a
    delta = thresh(delta, (-params.delta_max, params.delta_max))
    v = thresh(v, (pair_lo(params.v_max_riding),
                   pair_hi(params.v_max_riding)))
    psi = limit_angle(s[:, PSI] + t_s * v * torch.tan(delta) / params.l)
    y = s[:, Y] + t_s * v * torch.sin(psi)
    x = s[:, X] + t_s * v * torch.cos(psi)
    return torch.cat([torch.stack([x, y, psi, v, delta], dim=1), s[:, 5:]],
                     dim=1)


def step(params, state: AgentState, fx, fy) -> AgentState:
    """One control and kinematics step (reference vehicle.py:1274-1289)."""
    a, odelta, pid_e, pid_i = control(params, state, fx, fy)
    s = move(params, state.s, a, odelta)
    return state.replace(s=s, pid_e=pid_e, pid_i=pid_i)
