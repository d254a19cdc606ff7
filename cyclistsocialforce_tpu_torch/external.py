"""External force models through the engine's hooks: the Kaths model.

Counterpart of `cyclistsocialforce_tpu.external` (reference
external.py:1-182): the particle-based, velocity-anisotropic cyclist model
of Kaths (2023), DOI 10.3389/ffutr.2023.1183270, plugged into the engine
through its strategy-injection points `dest_force`, `rep_force`,
`rep_reduce`, `combine_forces` and the module's `step`
(`Engine.create(params, external)` picks them up).

The model works in (Fv, Ft) channels, a speed force and a turn (yaw-rate)
force, carried through the engine's two force slots.

As in the JAX package:
  - the destination bearing is `arctan(dy/dx)` (reference
    external.py:73-75), not atan2: the paper's small-heading assumption,
    with its dx = 0 behaviour (+-pi/2, or NaN when dy = 0 too);
  - the repulsion aggregates on the receiver side as the paper does
    (eqs. 6-9): Fv from the nearest anisotropically distorted neighbour
    (a masked min), Ft summed over the neighbours;
  - no stopping at traffic lights and no stochastic parameters (reference
    external.py:33-36).

The culled pair stage runs the generic path
(`Engine.repulsive_sum_neighbors_generic`, NeighborConfig backend "xla"),
which has no kernel in either package.
"""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.engine import _per_agent
from cyclistsocialforce_tpu_torch.state import PSI, V, X, Y, AgentState
from cyclistsocialforce_tpu_torch.utils.angles import limit_angle

N_STATES = 4

# deterministic parameter set of the velocity-anisotropic model
# (reference get_kaths_veloaniso_paramset, external.py:52-66)
KATHS_VELOANISO_PARAMS = {
    "A_tb": 0.48,
    "R_vb": 3.10,
    "R_tb": 1.91,
    "gamma_tb": 0.97,
    "gamma_vb": 1.03,
    "eta_vb": 2.05,
    "eta_tb": 1.96,
    "T_vb": 2.05,
    "T_tb": 1.15,
}


def _kp(params, key):
    """A Kaths parameter: from the params' `rep_force` / `dest_force`
    dicts (the reference's pluggable parameter slots, vehicle.py:111-125),
    else the published default. A number shared by the population."""
    return {**KATHS_VELOANISO_PARAMS, **params.rep_force,
            **params.dest_force}[key]


def dest_force_kaths(params, state: AgentState):
    """Destination force (Fv, Ft) (reference
    calc_kaths_veloaniso_destination_force, external.py:69-84): the speed
    relaxes toward v_desired and the heading toward the destination
    bearing, each with its own time constant. The model rides toward the
    CURRENT destination only (the reference never advances the queue; set
    it with `set_destinations(..., reset=True)`) and has no navigation
    FSM."""
    s = state.s
    t_b0 = torch.atan((state.dest[:, 1] - s[:, Y])
                      / (state.dest[:, 0] - s[:, X]))
    vdes = _per_agent(params.v_desired_default, state.n, s)
    fv = (vdes - s[:, V]) / _kp(params, "T_vb")
    ft = (t_b0 - s[:, PSI]) / _kp(params, "T_tb")
    return fv, ft, state


def rep_tile_kaths(params, src, recv):
    """Pairwise anisotropic interaction channels (Fv, Ft), [S, R] each.
    Per Kaths (2023) eqs. 6-9 the distance from receiver b to source i is
    distorted along b's heading (eta: lateral stretch; gamma: alignment
    shift by the headings' dot product):

        D* = d.e_v + eta |d.e_w| + gamma (e_vb . e_vi)
        Fv_pair = -A_vb(b) exp(-D_v* / R_vb)     (reduced by min)
        Ft_pair = -A_tb U exp(-D_t* / R_tb)      (reduced by sum)

    with U the side sign (eq. 8) deciding the turn direction. Per-agent
    parameters are the receivers'."""
    xs, ys, psis = src[0], src[1], src[2]
    xr, yr, psir, vr = recv
    dx = xs[:, None] - xr[None, :]                 # source - receiver
    dy = ys[:, None] - yr[None, :]
    cvr, svr = torch.cos(psir)[None, :], torch.sin(psir)[None, :]
    cvs, svs = torch.cos(psis)[:, None], torch.sin(psis)[:, None]

    d_ev = dx * cvr + dy * svr                     # along the receiver
    d_ew = -dx * svr + dy * cvr                    # lateral
    align = cvs * cvr + svs * svr                  # e_vb . e_vi

    t_vb = _kp(params, "T_vb")
    vdes = _per_agent(params.v_desired_default, xr.shape[0], xr)
    # the receiver's amplitude from its desired and current speed
    # (reference external.py:101-104)
    a_vb = (vdes[None, :] + (t_vb - 1.0) * vr[None, :]) / t_vb

    d_v = d_ev + _kp(params, "eta_vb") * torch.abs(d_ew) \
        + _kp(params, "gamma_vb") * align
    d_t = d_ev + _kp(params, "eta_tb") * torch.abs(d_ew) \
        + _kp(params, "gamma_tb") * align

    side = torch.sign(d_ew)                        # side of the receiver
    fv_pair = -a_vb * torch.exp(-d_v / _kp(params, "R_vb"))
    ft_pair = -_kp(params, "A_tb") * side * torch.exp(
        -d_t / _kp(params, "R_tb"))
    return fv_pair, ft_pair


def rep_reduce_kaths(fv_pair, ft_pair, tracked):
    """Receiver-side aggregation: Fv from the nearest tracked neighbour
    (the min of the negative exponentials, exp(-min D / R)), Ft summed."""
    fv = torch.amin(torch.where(tracked, fv_pair, 0.0), dim=0)
    ft = torch.sum(torch.where(tracked, ft_pair, 0.0), dim=0)
    return fv, ft


def combine_forces_kaths(frv, frt, fdv, fdt):
    """Channel-wise addition, no magnitude clamp (the clamp belongs to the
    velocity-vector semantics of the native models)."""
    return frv + fdv, frt + fdt


def step(params, state: AgentState, fv, ft) -> AgentState:
    """Kaths particle dynamics (reference step_kaths_particle_model,
    external.py:43-49): yaw rate and acceleration integrated."""
    s = state.s
    t_s = _per_agent(params.t_s, state.n, s)
    psi = limit_angle(ft * t_s + s[:, PSI])
    v = s[:, V] + t_s * fv
    x = s[:, X] + t_s * v * torch.cos(psi)
    y = s[:, Y] + t_s * v * torch.sin(psi)
    s_new = torch.cat([torch.stack([x, y, psi, v], dim=1), s[:, 4:]], dim=1)
    return state.replace(s=s_new, dyn_v=v)


# the engine's hooks (`Engine.create` reads them from the model module)
DEST_FORCE = dest_force_kaths
REP_FORCE = rep_tile_kaths
REP_REDUCE = rep_reduce_kaths
COMBINE_FORCES = combine_forces_kaths
