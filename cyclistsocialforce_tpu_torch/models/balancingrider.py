"""Balancing-rider bicycle: linearized Whipple-Carvallo dynamics under
full-state feedback, implicit-midpoint integration (counterpart of
`cyclistsocialforce_tpu.models.balancingrider`; reference
BalancingRiderBicycle / BalancingRiderDynamics, vehicle.py:1953-1988,
dynamics.py:261-706). Per step the reference

  1. P-controls the speed (dynamics.py:618-649),
  2. re-places the closed-loop poles at the midpoint speed wherever the
     speed changed (`ct.place`; the input gain is k_psi = K_x[4],
     dynamics.py:602-615, 465-477),
  3. solves the 7-state implicit-midpoint residual (dynamics.py:690-698).

Here, as in the JAX package, the placement is the closed-form Ackermann
gain of the SISO plant (`ops.control.ackermann`, the characteristic
polynomial straight from the pole features), and the residual's fixed
point is closed-form because the system is block-triangular: the five
bike-rider states [phi, delta, phidot, deltadot, psi] evolve linearly,

    x' = (I - h/2 Acl)^-1 [(I + h/2 Acl) x + h B K_psi psi_c],

one batched 5x5 solve (`ops.smallmat.solve_small`, pivoted), and the
positions follow with the midpoint yaw. The gain K comes from the exact
placement, the fixed gains, or a table or piecewise quintic over speed
(`BalancingRiderParams.create(gains_lut=, gains_poly=)`), recomputed only
where the speed changed; `prop_lut`/`prop_poly` replace the whole update
by a propagator over the midpoint speed. The frame flips between the CSF
frame (x forward, y left, z up) and the bike model's (y right, z down)
are the reference's (dynamics.py:321-399).

The stochastic control behavior (reference parameters.py:1376-1411)
resamples a rider's pole features from the conditional pole model
(`behavior.PoleModelRT`) when its speed moved more than a threshold since
its last update, inside the gain update; the gains are then the exact
placement of its features, or K = charpoly(features) M(v) through the
Ackermann basis M as a table or a piecewise quintic. A budget caps the
riders sampled per step (the needy ones compacted into a fixed buffer,
the rest deferred) and a cadence samples only every K-th global step.
Torque disturbances (removed upstream, dynamics.py:317-318, as in the
JAX package) add a Bernoulli roll or steer torque per step. Every draw
is the JAX package's: `state.agent_streams` of (key, t_glob, uid, salt),
so a rider's draws follow it through any row permutation.

Every operation is elementwise over [N] or [N, 5, 5] rows, or a gather,
scatter or cumulative sum of fixed size (no matrix product that TF32
could round, no host read, no shape that depends on the data), so a CUDA
graph captures the step. The constant tensors it reads come from
`step_constants`.
"""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.ops.control import (
    ackermann, charpoly_from_pole_features)
from cyclistsocialforce_tpu_torch.ops.piecewise import (coeff_matrix,
                                                        eval_piecewise_poly)
from cyclistsocialforce_tpu_torch.ops.smallmat import (matvec_small,
                                                       solve_small)
from cyclistsocialforce_tpu_torch.ops import agent_step as AS
from cyclistsocialforce_tpu_torch.ops import random as rnd
from cyclistsocialforce_tpu_torch.params import pair_hi, pair_lo
from cyclistsocialforce_tpu_torch.state import (DDELTA, DELTA, DTHETA, PSI,
                                                THETA, V, X, Y, AgentState,
                                                agent_streams)
from cyclistsocialforce_tpu_torch.utils.angles import (angle_difference,
                                                       limit_angle, thresh)

N_STATES = 8
REP_FORCE = "twod"
DEST_FORCE = "direct"   # calc_direct_approach_dest_force, vehicle.py:2078
STATE_WIDTHS = {"dyn_x": 7, "dyn_gains": 12, "zrid": 0}

# dyn_gains columns: the cached feedback gains K_x, the stochastic mode's
# current pole features and the speed of their last resampling
_KX = slice(0, 5)
_PF = slice(5, 10)
_VLAST = 10

# stream salts of `state.agent_streams` (the JAX package's)
_SALT_DIST = 1           # torque-disturbance Bernoulli draws
_SALT_POLES = 2          # pole-feature resampling in the step
_SALT_INIT = 3           # initial pole-feature draw (init_gains)

# params field -> step_constants key of the constant tensors
_MATRICES = (("A0", "br_A0"), ("A1", "br_A1"), ("A2", "br_A2"),
             ("B", "br_B"), ("B_roll", "br_B_roll"))
_BEHAVIOR = (("pole_lin", "br_pole_lin"), ("gains_fixed", "br_gains_fixed"))


def _const(value, dtype, device):
    """A params value as a tensor of `dtype` on `device` (nested tuples of
    floats or a per-rider tensor); None stays None."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.tensor(value, dtype=dtype, device=device)


def _table(lut, dtype, device):
    return None if lut is None else (lut[0].to(device=device, dtype=dtype),
                                     lut[1], lut[2])


def step_constants(params, dtype, device) -> dict:
    """The device tensors `step` reads that no step changes, as its
    `constants` keyword: A0, A1, A2, B, the pole functions or
    fixed gains, the `br_gains_poly`/`br_prop_poly`/`br_ackermann_poly`
    coefficient matrices, the `br_gains_lut`/`br_prop_lut` tables and the
    `br_ackermann_lut` one as [G, 30] rows, and the pole model
    (`PoleModelRT.to`), each in `dtype` on `device`. An engine builds them once per dtype and device and keeps
    them as long as its captured chunks, which read them by address
    (`Engine.kept_constants`)."""
    c = {key: _const(getattr(params, f), dtype, device)
         for key, f in _MATRICES + _BEHAVIOR}
    for key, f in (("gains_coeffs", "br_gains_poly"),
                   ("prop_coeffs", "br_prop_poly"),
                   ("ack_coeffs", "br_ackermann_poly")):
        poly = getattr(params, f)
        c[key] = None if poly is None else coeff_matrix(poly, dtype, device)
    c["gains_lut"] = _table(params.br_gains_lut, dtype, device)
    c["prop_lut"] = _table(params.br_prop_lut, dtype, device)
    ack = params.br_ackermann_lut
    c["ack_lut"] = None if ack is None else _table(
        (ack[0].reshape(ack[0].shape[0], 30),) + tuple(ack[1:]), dtype,
        device)
    rt = params.polemodel_rt
    c["polemodel"] = None if rt is None else rt.to(dtype, device)
    return {"constants": c}


def gain_mode(params) -> str:
    """How `step` updates the gains, the first of the modes in the order
    it tries them: "prop_poly" or "prop_lut" (a propagator of the
    midpoint speed, a piecewise quintic or a table, in place of the whole
    update), "fixed", "poly" (a piecewise quintic of speed,
    `create(gains_poly=)`), "lut", "stochastic" (the placement of
    resampled pole features) or "exact" (the Ackermann placement)."""
    if params.br_prop_poly is not None:
        return "prop_poly"
    if params.br_prop_lut is not None:
        return "prop_lut"
    if params.br_gains_fixed is not None:
        return "fixed"
    if params.br_gains_poly is not None:
        return "poly"
    if params.br_gains_lut is not None:
        return "lut"
    if params.stochastic_control_behavior:
        return "stochastic"
    return "exact"


def agent_kernels(params):
    """The per-agent kernels of a step (`ops.agent_step`), agent_pre with
    the straight destination force and agent_post_whipple, the twod field
    culled between them, where the gains are a piecewise quintic of speed
    (`gain_mode` "poly") whose coefficients the kernel stages in shared
    memory (`WHIPPLE_MAX_COEFFS`), with no resampling and no torque
    disturbances; else None (the torch chain)."""
    poly = params.br_gains_poly
    if (gain_mode(params) != "poly" or params.stochastic_control_behavior
            or params.br_disturb
            or len(poly[0]) * len(poly[0][0]) > AS.WHIPPLE_MAX_COEFFS):
        return None
    return AS.AgentKernels("straight", "agent_post_whipple",
                           AS.WHIPPLE_FIELDS, ("twod",))


def _per_rider(value, like):
    """A shared (number) or per-rider ([N] tensor) parameter, in `like`'s
    dtype."""
    return value.to(like.dtype) if isinstance(value, torch.Tensor) else value


def clock_period(params) -> int:
    """The period of the step's dependence on the global step clock beyond
    its random streams: the resampling cadence (1: none). An engine that
    knows the clock on the host passes `t_host` to `step`."""
    if params.stochastic_control_behavior:
        return max(int(params.br_resample_every or 1), 1)
    return 1


def _pole_features(params, c, state: AgentState, v, gate=None,
                   t_host=None):
    """(features [N, 5], state) at speeds v: the linear mean functions, or
    in stochastic mode each rider's current sample in dyn_gains,
    resampled where |v - v_last| exceeds the threshold (and `gate`, the
    riders whose gains the step recomputes; None in `init_gains`, where
    every rider draws under its own salt and neither budget nor cadence
    applies). With a budget b the needy riders' rows are compacted in
    index order into a [b + 1] buffer whose last slot takes the dropped
    ones, sampled, and scattered back; the rest stay needy. With a
    cadence K the resampler runs where t_glob % K == 0: decided on the
    host from `t_host` (the global step, as the engine knows it), or,
    without it, computed every step and selected on the device. Either
    way the result is the JAX package's (`_pole_features`)."""
    lin = c["pole_lin"]
    feats_lin = lin[..., 0] + lin[..., 1] * v[:, None]
    if not params.stochastic_control_behavior:
        return feats_lin, state
    n = state.n
    dg = state.dyn_gains
    cur, v_last = dg[:, _PF], dg[:, _VLAST]
    need = (v - v_last).abs() > _per_rider(
        params.controlparam_resampling_speedthresh, v)
    if gate is not None:
        need = need & gate
    salt = _SALT_POLES if gate is not None else _SALT_INIT
    rt = c["polemodel"]
    budget = int(params.br_resample_budget or 0)
    every = int(params.br_resample_every or 1)

    if gate is not None and budget:
        b = min(budget, n)

        def resample():
            # compaction without a host read: each needy row's rank, the
            # rows beyond the budget and the others sent to slot b
            rows = torch.arange(n, device=v.device)
            pos = torch.cumsum(need.to(torch.int32), 0) - 1
            tgt = torch.where(need & (pos < b), pos, b).long()
            idx = torch.full((b + 1,), n, dtype=torch.long,
                             device=v.device).scatter(0, tgt, rows)[:b]
            safe = torch.clamp_max(idx, n - 1)
            v_sub = v[safe]
            # the subset's streams by uid: the same as gathering [N] keys
            keys = agent_streams(state.key, state.t_glob, state.uid[safe],
                                 salt)
            sampled, _ = rt.sample_features_batch(keys, v_sub)
            # rows n (no rider) land in a dummy row, then cut off
            feats = torch.cat([cur, cur[:1]]).index_copy(
                0, idx, sampled.to(cur.dtype))[:n]
            vl = torch.cat([v_last, v_last[:1]]).index_copy(0, idx,
                                                             v_sub)[:n]
            return feats, vl
    else:
        def resample():
            keys = agent_streams(state.key, state.t_glob, state.uid, salt)
            sampled, _ = rt.sample_features_batch(keys, v)
            return (torch.where(need[:, None], sampled.to(cur.dtype), cur),
                    torch.where(need, v, v_last))

    if every > 1 and gate is not None:
        if t_host is None:
            fire = state.t_glob % every == 0
            new_f, new_v = resample()
            feats = torch.where(fire, new_f, cur)
            v_last = torch.where(fire, new_v, v_last)
        elif t_host % every == 0:
            feats, v_last = resample()
        else:
            return cur, state
    else:
        feats, v_last = resample()
    return feats, state.replace(dyn_gains=torch.cat(
        [dg[:, :5], feats, v_last[:, None], dg[:, 11:]], dim=1))


def _disturbances(params, state: AgentState):
    """The roll and steer torque impulses [N] of this step: a Bernoulli
    draw per rider against p_dist_roll and p_dist_steer, from one uniform
    pair per rider under salt 1 (zeros without disturbances)."""
    s = state.s
    if not params.br_disturb:
        return 0.0, 0.0
    keys = agent_streams(state.key, state.t_glob, state.uid, _SALT_DIST)
    uu = rnd.uniform(keys, (2,), s.dtype)

    def torque(u, p, t):
        return (u < p).to(s.dtype) * _per_rider(t, s)

    return (torque(uu[:, 0], params.p_dist_roll, params.T_dist_roll),
            torque(uu[:, 1], params.p_dist_steer, params.T_dist_steer))


def _system(c, v):
    """A(v) [N, 5, 5] at speeds v [N]."""
    vv = v[:, None, None]
    return c["A0"] + vv * c["A1"] + (vv * vv) * c["A2"]


def _exact_gains(c, v):
    """K_x(v) [N, 5]: the Ackermann placement, on A(v), of the poles the
    linear pole functions give at v (reference dynamics.py:602-615,
    1167-1227)."""
    lin = c["pole_lin"]
    feats = lin[..., 0] + lin[..., 1] * v[:, None]
    return ackermann(_system(c, v), c["B"].expand(v.shape[0], 5),
                     charpoly_from_pole_features(feats))


def init_gains(params, state: AgentState) -> AgentState:
    """The gains at the initial speed (reference dynamics.py:306): the
    fixed gains, else the exact placement, whatever the gain mode of the
    steps; in stochastic mode of each rider's first draw of pole features
    (salt 3), which it keeps with its speed."""
    s = state.s
    c = step_constants(params, s.dtype, s.device)["constants"]
    v0 = s[:, V]
    if c["gains_fixed"] is not None:
        K = c["gains_fixed"].expand(state.n, 5)
    elif params.stochastic_control_behavior:
        feats, state = _pole_features(params, c, state, v0)
        K = ackermann(_system(c, v0), c["B"].expand(state.n, 5),
                      charpoly_from_pole_features(feats))
        dg = state.dyn_gains
        return state.replace(dyn_gains=torch.cat(
            [K.to(s.dtype), feats, v0[:, None], dg[:, 11:]], dim=1))
    else:
        K = _exact_gains(c, v0)
    return state.replace(dyn_gains=torch.cat(
        [K.to(s.dtype), state.dyn_gains[:, 5:]], dim=1))


def prepare(params, state: AgentState) -> AgentState:
    """CSF state -> bike-model latents (reference dynamics.py:361-399):
    x = [roll, -steer, rollrate, -steerrate, -yaw, x, -y], then the
    initial gains."""
    s = state.s
    dyn_x = torch.stack([
        s[:, THETA], -s[:, DELTA], s[:, DTHETA], -s[:, DDELTA],
        -s[:, PSI], s[:, X], -s[:, Y]], dim=1)
    return init_gains(params, state.replace(dyn_x=dyn_x,
                                            dyn_v=s[:, V].clone()))


def _finish(state: AgentState, dyn_x, v_new, K) -> AgentState:
    """Bike frame -> CSF state (reference dynamics.py:321-358), and the
    gain cache."""
    s_new = torch.stack([
        dyn_x[:, 5],                       # x
        -dyn_x[:, 6],                      # y
        -limit_angle(dyn_x[:, 4]),         # yaw
        v_new,                             # speed
        -limit_angle(dyn_x[:, 1]),         # steer
        limit_angle(dyn_x[:, 0]),          # roll
        -dyn_x[:, 3],                      # steer rate
        dyn_x[:, 2],                       # roll rate
    ], dim=1)
    dg = torch.cat([K, state.dyn_gains[:, 5:]], dim=1)
    return state.replace(s=s_new, dyn_x=dyn_x, dyn_v=v_new, dyn_gains=dg)


def _positions(x, psi_new, v_mid, h):
    """The explicit midpoint position rows: [x, y] in the bike frame."""
    psi_mid = (x[:, 4] + psi_new) / 2.0
    return (x[:, 5] + h * v_mid * torch.cos(psi_mid),
            x[:, 6] + h * v_mid * torch.sin(psi_mid))


def _prop_apply(state, rt, psi_c, v_mid, h, v_new, t_roll, t_steer):
    """One midpoint update through the 40 [N] propagator rows `rt`
    ([P | Q | R | K], the prop_lut and prop_poly layout): an unrolled 5x5
    matvec on [N] rows with the disturbance torques, then the
    positions."""
    disturbed = isinstance(t_roll, torch.Tensor)
    u = rt[39] * psi_c                                 # K[4] == K_u
    if disturbed:
        u = u + t_steer
    xs = [state.dyn_x[:, j] for j in range(5)]
    x5n = [sum(rt[5 * i + j] * xs[j] for j in range(5)) + rt[25 + i] * u
           for i in range(5)]
    if disturbed:
        x5n = [x + rt[30 + i] * t_roll for i, x in enumerate(x5n)]
    px, py = _positions(state.dyn_x, x5n[4], v_mid, h)
    dyn_x = torch.stack(x5n + [px, py], dim=1)
    return _finish(state, dyn_x, v_new, torch.stack(rt[35:40], dim=1))


def _interp(lut, v):
    """The rows i0, i0 + 1 of table `lut` = (tab [G, M], v0, dv) around
    speeds v, and the weight w [N, 1] of row i0 + 1 (the coordinate
    clamped to the grid: no extrapolation)."""
    tab, v0, dv = lut
    g = tab.shape[0]
    t = torch.clamp((v - v0) / dv, 0.0, g - 1.0)
    i0 = torch.clamp(torch.floor(t).long(), 0, g - 2)
    return tab[i0], tab[i0 + 1], (t - i0.to(t.dtype))[:, None]


def _ackermann_basis_gains(feats, basis):
    """K [N, 5] = charpoly(feats) M: the 30 basis entries `basis` ([N]
    each, m = 5 c + k) contracted with the six characteristic
    coefficients, in the JAX package's order."""
    ct = charpoly_from_pole_features(feats).unbind(-1)
    return torch.stack([sum(ct[j] * basis[5 * j + k] for j in range(6))
                        for k in range(5)], dim=1)


def step(params, state: AgentState, fx, fy, constants=None,
         t_host=None) -> AgentState:
    """One balancing-rider step (reference dynamics.py:674-706).
    `constants`: see `step_constants` (built here when None). `t_host`:
    the global step, where the caller knows it on the host (see
    `_pole_features`)."""
    s = state.s
    c = constants or step_constants(params, s.dtype, s.device)["constants"]
    h = _per_rider(params.t_s, s)
    a_max, v_max = params.a_max, params.v_max_riding

    # ---- speed P-control + Euler integration (dynamics.py:618-649)
    v_old = s[:, V]
    vd = torch.sqrt(fx * fx + fy * fy)
    a = _per_rider(params.k_p_v, s) * (vd - v_old)
    a = thresh(a, (_per_rider(pair_lo(a_max), s),
                   _per_rider(pair_hi(a_max), s)))
    v_new = thresh(v_old + h * a, (_per_rider(pair_lo(v_max), s),
                                   _per_rider(pair_hi(v_max), s)))
    v_mid = (v_new + v_old) / 2.0

    # ---- commanded yaw in the bike frame (dynamics.py:652-671)
    psi_bike = state.dyn_x[:, 4]
    psi_F = limit_angle(torch.atan2(-fy, fx))
    psi_c = psi_bike + angle_difference(psi_bike, psi_F)
    t_roll, t_steer = _disturbances(params, state)

    mode = gain_mode(params)
    if mode == "prop_poly":
        # the propagator as a piecewise quintic of the midpoint speed;
        # below-band speeds clamp the whole propagator to the band edge
        rt = eval_piecewise_poly(params.br_prop_poly, v_mid, 40,
                                 c["prop_coeffs"])
        return _prop_apply(state, rt, psi_c, v_mid, h, v_new, t_roll,
                           t_steer)
    if mode == "prop_lut":
        # the propagator interpolated on the speed grid: K(v_mid) every
        # step (the stale-gain hold of the exact path is dropped)
        r0, r1, w = _interp(c["prop_lut"], v_mid)
        row = r0 + (r1 - r0) * w                           # [N, 40]
        return _prop_apply(state, list(row.T), psi_c, v_mid, h, v_new,
                           t_roll, t_steer)

    # ---- gains: recomputed only where the speed changed, else the cache
    # (reference dynamics.py:680-681)
    changed = (v_new != v_old)[:, None]
    if mode == "fixed":
        K = c["gains_fixed"].expand(state.n, 5)
    else:
        if mode == "poly":
            # below-band speeds (v < GAINS_POLY_V_LO) clamp to the band edge
            K_new = torch.stack(eval_piecewise_poly(
                params.br_gains_poly, v_mid, 5, c["gains_coeffs"]), dim=1)
        elif mode == "lut":
            r0, r1, w = _interp(c["gains_lut"], v_mid)
            K_new = r0 * (1.0 - w) + r1 * w
        elif mode == "stochastic":
            feats, state = _pole_features(params, c, state, v_mid,
                                          changed[:, 0], t_host)
            if params.br_ackermann_poly is not None:
                basis = eval_piecewise_poly(params.br_ackermann_poly, v_mid,
                                            30, c["ack_coeffs"])
                K_new = _ackermann_basis_gains(feats, basis)
            elif params.br_ackermann_lut is not None:
                r0, r1, w = _interp(c["ack_lut"], v_mid)
                K_new = _ackermann_basis_gains(feats,
                                               list((r0 + (r1 - r0) * w).T))
            else:
                K_new = ackermann(_system(c, v_mid),
                                  c["B"].expand(state.n, 5),
                                  charpoly_from_pole_features(feats))
        else:
            K_new = _exact_gains(c, v_mid)
        K = torch.where(changed, K_new, state.dyn_gains[:, _KX])

    # ---- closed-form implicit midpoint of the block-triangular system
    x = state.dyn_x
    x5 = x[:, :5]
    h1, h2 = ((h[:, None], h[:, None, None]) if isinstance(h, torch.Tensor)
              else (h, h))
    Acl = _system(c, v_mid) - c["B"][:, None] * K[:, None, :]
    u = K[:, 4] * psi_c                    # k_psi == K_u (dynamics.py:465)
    drive = c["B"] * u[:, None]
    if params.br_disturb:
        drive = (c["B"] * (u + t_steer)[:, None]
                 + c["B_roll"] * t_roll[:, None])
    rhs = x5 + (h1 / 2.0) * matvec_small(Acl, x5) + h1 * drive
    eye = torch.eye(5, dtype=s.dtype, device=s.device)
    x5n = solve_small(eye - (h2 / 2.0) * Acl, rhs)
    px, py = _positions(x, x5n[:, 4], v_mid, h)
    dyn_x = torch.cat([x5n, px[:, None], py[:, None]], dim=1)
    return _finish(state, dyn_x, v_new, K)
