"""Planar two-wheeler: a 2-state steer/yaw state space with pole placement
per step and exponential speed dynamics (counterpart of
`cyclistsocialforce_tpu.models.planarbicycle`; reference PlanarBicycle /
PlanarTwoWheelerDynamics / PPointSpeedDynamics, vehicle.py:2031-2074,
dynamics.py:145-258).

Per step the reference re-runs `ct.place` on

    A(v) = [[0, 0], [v/w, 0]],  B = [1, 0]^T,  x = [delta, psi]

at the current (pre-step) speed, scales the reference gain K_u with a
1000-sample simulated step response, propagates one sample with
`ct.forced_response`, advances the speed by the closed-form solution of
the P-controlled speed ODE, and Euler-integrates the position at the new
speed and yaw. Here, batched over the agents as in the JAX package:

  - pole placement: Ackermann (`ops.control.ackermann`; single-input
    placement is unique, so it equals `ct.place`),
  - K_u: the closed loop's step response reproduced exactly from its
    first-order-hold discretization, y_999 = C [(I - Ad)^-1 (I - Ad^989)
    P + Ad^989 Q / dt], K_u = 1 / y_999 (`forced_response`'s FOH
    propagation sample for sample, at the reference's t_end = 10 s,
    dt = 0.01 s), the 2x2 solve by `ops.smallmat.solve_small`,
  - one sample: zero-order hold through the augmented exponential.

At v = 0 the pair (A, B) is not controllable and the reference asserts
(dynamics.py:1151-1153); here the placement speed is held at |v| >= 1e-9,
so the step stays finite.
"""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch import engine as eng
from cyclistsocialforce_tpu_torch.ops.control import (ackermann,
                                                      discretize_foh,
                                                      matrix_power)
from cyclistsocialforce_tpu_torch.ops.smallmat import (matmul_small,
                                                       matvec_small,
                                                       solve_small)
from cyclistsocialforce_tpu_torch.state import DELTA, PSI, V, X, Y, AgentState
from cyclistsocialforce_tpu_torch.utils.angles import limit_angle

N_STATES = 5
REP_FORCE = "twod"
DEST_FORCE = "spline"
STATE_WIDTHS = {"dyn_x": 2, "dyn_gains": 0, "zrid": 0}

# from_pole_placement's fixed step-response schedule
# (reference dynamics.py:1167-1178: t_end=10.0, t_s=0.01, step at k=10)
_KU_DT = 0.01
_KU_LAST = 999
_KU_STEP_ON = 10


def prepare(params, state: AgentState) -> AgentState:
    """Dynamics latents [delta, psi] from the CSF state (reference
    dynamics.py:192-195); kept unwrapped across steps."""
    dyn_x = state.dyn_x.clone()
    dyn_x[:, 0] = state.s[:, DELTA]
    dyn_x[:, 1] = state.s[:, PSI]
    return state.replace(dyn_x=dyn_x, dyn_v=state.s[:, V].clone())


def desired_quadratic(poles, n: int, like):
    """[n, 3] monic s^2 - 2 Re(p) s + |p|^2 of each rider's first pole of
    the conjugate pair (a shared tuple of complex numbers, or a per-rider
    complex [n, 2] tensor), in `like`'s dtype and on its device."""
    if isinstance(poles, torch.Tensor):
        p0 = poles[..., 0] if poles.ndim else poles
        pr, pi = p0.real, p0.imag
    else:
        p0 = complex(poles[0])
        pr, pi = p0.real, p0.imag
    cols = (1.0, -2.0 * pr, pr * pr + pi * pi)
    return torch.stack([eng._per_agent(c, n, like) for c in cols], dim=1)


def step(params, state: AgentState, fx, fy) -> AgentState:
    """One planar-bicycle step (reference dynamics.py:221-258)."""
    n = state.n
    s = state.s
    dtype, dev = s.dtype, s.device

    def b(name):
        return eng._per_agent(getattr(params, name), n, s)

    psi_d = torch.atan2(fy, fx)
    v_d = torch.sqrt(fx * fx + fy * fy)
    w, k_p_v, t_s = b("l"), b("k_p_v"), b("t_s")
    v = s[:, V]

    vv = torch.where(torch.abs(v) < 1e-9, 1e-9, v)
    A = torch.zeros((n, 2, 2), dtype=dtype, device=dev)
    A[:, 1, 0] = vv / w
    B = torch.zeros((n, 2), dtype=dtype, device=dev)
    B[:, 0] = 1.0
    eye = torch.eye(2, dtype=dtype, device=dev)

    # Ackermann placement of the conjugate pole pair
    K = ackermann(A, B, desired_quadratic(params.poles, n, s))
    Acl = A - B[:, :, None] * K[:, None, :]

    # K_u from the exact FOH step response on the reference's fixed grid
    Ad, P, Q = discretize_foh(Acl, B, _KU_DT)
    Adn = matrix_power(Ad, _KU_LAST - _KU_STEP_ON)          # Ad^989
    S = solve_small(eye - Ad, matmul_small(eye - Adn, P))
    y_ss = (S + matmul_small(Adn, Q) / _KU_DT)[:, 1, 0]     # C = [0, 1]
    K_u = 1.0 / y_ss

    # one-sample ZOH propagation of (Acl, B K_u) under constant psi_d
    Ad1, P1, _ = discretize_foh(Acl, B * K_u[:, None], t_s)
    x_next = (matvec_small(Ad1, state.dyn_x[:, :2])
              + P1[..., 0] * psi_d[:, None])

    # speed: closed-form exponential P control (dynamics.py:145-175)
    v_new = v_d + (v - v_d) * torch.exp(-k_p_v * t_s)

    psi = limit_angle(x_next[:, 1])
    delta = limit_angle(x_next[:, 0])
    s_new = s.clone()
    s_new[:, X] = s[:, X] + t_s * v_new * torch.cos(psi)
    s_new[:, Y] = s[:, Y] + t_s * v_new * torch.sin(psi)
    s_new[:, PSI] = psi
    s_new[:, V] = v_new
    s_new[:, DELTA] = delta
    dyn_x = torch.cat([x_next, state.dyn_x[:, 2:]], dim=1)
    return state.replace(s=s_new, dyn_x=dyn_x, dyn_v=v_new)
