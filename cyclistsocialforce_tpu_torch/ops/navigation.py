"""Navigation finite-state machine and destination-queue ops, batched over
agents.

Counterpart of `cyclistsocialforce_tpu.ops.navigation`, whose functions
take one agent's scalars and are vmapped by the engine; here every
argument carries the leading agent axis [N]. The boolean next-state
equations are the reference's (vehicle.py:354-457) verbatim.
"""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.params import pair_lo

BRAKE_SAFETY_K = 1.5  # reference vehicle.py:377


def queue_take(destqueue, idx):
    """Row idx[a] of agent a's [Q, 3] queue; [N, 3]. Indices are in
    range by construction (pointers are clipped to nq - 1 <= Q - 1)."""
    return torch.gather(
        destqueue, 1, idx.long()[:, None, None].expand(-1, 1, 3))[:, 0]


def _norm(d):
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])


def dest_distance(pos, destqueue, destpointer):
    """Distance from `pos` [N, 2] to the current queue destination
    (reference vehicle.py:596-604)."""
    return _norm(queue_take(destqueue, destpointer)[:, :2] - pos)


def update_destination(pos, dest, destqueue, destpointer, nq, znav,
                       i, i_stopsignal, d_stopsignal, d_arrived_inter):
    """Advance the destination queues (reference vehicle.py:545-594):
    no-op while stopping or arrived; advance on arrival at an intermediate
    destination; jump one ahead if the next-next destination is closer;
    log the step and distance when the destination turns into a stop.

    Returns (dest, destpointer, i_stopsignal, d_stopsignal)."""
    dnext = dest_distance(pos, destqueue, destpointer)
    skip = znav[:, 1] | znav[:, 2]

    adv = dnext <= d_arrived_inter
    ptr = torch.where(adv, torch.minimum(destpointer + 1, nq - 1),
                      destpointer)

    # jump-ahead check (against dnext computed BEFORE the advance)
    has_next = ptr < nq - 1
    nxt = torch.clamp(ptr + 1, 0, destqueue.shape[1] - 1)
    dnextnext = _norm(queue_take(destqueue, nxt)[:, :2] - pos)
    ptr = torch.where(has_next & (dnextnext < dnext), ptr + 1, ptr)

    ptr = torch.where(skip, destpointer, ptr)
    new_dest = torch.where(skip[:, None], dest, queue_take(destqueue, ptr))

    became_stop = (~skip) & (dest[:, 2] <= 0) & (new_dest[:, 2] > 0)
    i_stopsignal = torch.where(became_stop, i, i_stopsignal)
    d_stopsignal = torch.where(
        became_stop, _norm(dest[:, :2] - new_dest[:, :2]), d_stopsignal)
    return new_dest, ptr, i_stopsignal, d_stopsignal


def update_nav_state(v, ddest, stop_flag, znav, znavparams, i, params):
    """One transition of the 3-state navigation FSM (reference
    vehicle.py:354-457); states z0 cruising, z1 stopping, z2 arrived.
    `params` is an engine.NavParams (floats or per-agent tensors).

    Returns (vd, znav_next, znavparams_next), vd the desired speed."""
    k = BRAKE_SAFETY_K
    vh = params.v_max_harddecel

    # braking-distance profile: gentle-first deceleration distances
    d0_new = 0.5 * (vh * vh - v * v) / pair_lo(params.a_desired_default)
    d1_new = 0.5 * (-(vh * vh)) / pair_lo(params.a_max)
    d0 = torch.where(znav[:, 0], d0_new, znavparams[:, 1])
    d1 = torch.where(znav[:, 0], d1_new, znavparams[:, 2])

    x0 = stop_flag > 0
    x1 = ddest <= k * (d0 + d1)
    x2 = ddest <= params.d_arrived_stop
    x3 = v <= params.v_max_stop

    z0, z1, z2 = znav[:, 0], znav[:, 1], znav[:, 2]
    n0 = (~x0) | (x0 & (~x1) & ((z0 & ~x2) | z1))
    n1 = x0 & ((z0 & (((~x2) & x1) | (x2 & ~x3)))
               | (z1 & x1 & ((~x2) | (~x3))))
    n2 = x0 & (((z0 | z1) & x2 & x3) | z2)
    znav_next = torch.stack([n0, n1, n2], dim=1)

    # latch the braking profile on the cruising -> stopping transition
    latch = z0 & n1
    znavparams_next = torch.where(
        latch[:, None],
        torch.stack([v, d0, d1, i.to(v.dtype)], dim=1),
        znavparams)

    # the z1 branch is selected only after the profile was latched (so
    # the divisors are nonzero there); guarded because where evaluates
    # both branches
    zp0, zp1, zp2 = (znavparams_next[:, 0], znavparams_next[:, 1],
                     znavparams_next[:, 2])
    d0_safe = torch.where(zp1 != 0, zp1, 1.0)
    d1_safe = torch.where(zp2 != 0, zp2, 1.0)
    vd_z1_near = vh / d1_safe * ddest / k
    vd_z1_far = (zp0 - vh) / d0_safe * (ddest - zp2) / k + vh
    vd_z1 = torch.where(ddest < k * zp2, vd_z1_near, vd_z1_far)
    vd = torch.where(n1, vd_z1, torch.zeros_like(v))
    vd = torch.where(n0, params.v_desired_default, vd)
    return vd, znav_next, znavparams_next
