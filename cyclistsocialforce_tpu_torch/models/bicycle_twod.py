"""2D kinematic two-wheeler of the BMD2023 paper, "TwoDBicycle"
(counterpart of `cyclistsocialforce_tpu.models.bicycle_twod`; reference
vehicle.py:1292-1648): the P-controlled kinematics of bicycle2d with the
spline path-planning destination force (`engine.dest_force_spline`), the
angular-modulated elliptic "twod" repulsive field, and an arrived-freeze:
once the navigation FSM latches "arrived", speed, steer and roll are zero
and control is skipped (reference vehicle.py:1397-1400)."""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.models import bicycle2d
from cyclistsocialforce_tpu_torch.ops import agent_step as AS
from cyclistsocialforce_tpu_torch.state import (DELTA, STATE_DIM, THETA, V,
                                                AgentState)

N_STATES = 5
REP_FORCE = "twod"
DEST_FORCE = "spline"
STATE_WIDTHS = {"dyn_x": 0, "dyn_gains": 0, "zrid": 0}


def agent_kernels(params) -> AS.AgentKernels:
    """The per-agent kernels of a step (`ops.agent_step`): agent_pre's
    spline instance (the spline force, which also reads g), then
    agent_post's twod instance (the arrived-freeze), the twod or legacy
    field culled between them."""
    return AS.AgentKernels("spline", "agent_post_twod",
                           AS.MODEL_FIELDS + AS.SPLINE_FIELDS,
                           ("twod", "legacy"))


def step(params, state: AgentState, fx, fy) -> AgentState:
    """One control and kinematics step with the arrived-freeze (reference
    vehicle.py:1386-1414)."""
    a, odelta, pid_e, pid_i = bicycle2d.control(params, state, fx, fy)
    s_moved = bicycle2d.move(params, state.s, a, odelta)

    arrived = state.znav[:, 2:3]
    # speed, steer and roll held at zero (a mask built on the device: a
    # step copies nothing from the host)
    col = torch.arange(STATE_DIM, device=state.s.device)
    s_frozen = torch.where((col == V) | (col == DELTA) | (col == THETA), 0.0,
                           state.s)
    s = torch.where(arrived, s_frozen, s_moved)
    # control (and the PID state with it) is skipped once arrived
    pid_e = torch.where(arrived, state.pid_e, pid_e)
    pid_i = torch.where(arrived, state.pid_i, pid_i)
    return state.replace(s=s, pid_e=pid_e, pid_i=pid_i)
