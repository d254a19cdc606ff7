"""Destination force and force combination of the PyTorch port
(counterpart of the destination-force part of
`cyclistsocialforce_tpu.ops.forces`). Forces have velocity semantics:
|F| is the desired speed, atan2(Fy, Fx) the desired heading."""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.utils.angles import limit_magnitude


def dest_force_straight(x, y, dest_x, dest_y, vd, ddest):
    """Straight-line destination force (reference vehicle.py:1150-1187):
    points from (x, y) to the destination with magnitude vd; zero at
    ddest == 0."""
    ok = ddest > 0
    safe = torch.where(ok, ddest, 1.0)
    fx = torch.where(ok, -vd * (x - dest_x) / safe, 0.0)
    fy = torch.where(ok, -vd * (y - dest_y) / safe, 0.0)
    return fx, fy


def clamp_add_dest(frep_x, frep_y, fdest_x, fdest_y):
    """Clamp the summed repulsive force to the destination-force magnitude
    and add the destination force (reference intersection.py:841-848)."""
    fdest_mag = torch.sqrt(fdest_x * fdest_x + fdest_y * fdest_y)
    frep_x, frep_y = limit_magnitude(frep_x, frep_y, fdest_mag)
    return frep_x + fdest_x, frep_y + fdest_y
