"""Closed-loop crowd traffic on routes: the crowd of `crowd` (the same
draws from the same seed), and each rider a route of waypoints along a
direction of its own, drawn from the seed: the k-th (k = 0, 1, ...)
(k + 1) x `waypoint_spacing_m` along it and up to `waypoint_side_m` to
either side, none a stop. The first waypoint is the rider's destination.
"""

from __future__ import annotations

import numpy as np

from benchmark.generators import crowd


def generate(mix: dict, seed: int) -> dict:
    """`crowd.generate`'s inputs with `waypoints` [rows, K, 2] (float64)
    and `dest` the first of them."""
    out = crowd.generate(mix, seed)
    rows, k = out["rows"], int(mix["waypoints_per_rider"])
    spacing = float(mix["waypoint_spacing_m"])
    side = float(mix["waypoint_side_m"])
    rng = np.random.default_rng([int(seed), 1])
    heading = rng.uniform(-np.pi, np.pi, rows)[:, None]
    off = rng.uniform(-side, side, (rows, k))
    along = spacing * np.arange(1, k + 1)[None, :]
    c, s = np.cos(heading), np.sin(heading)
    pos = out["s0"][:, :2]
    wp = np.stack([pos[:, :1] + along * c - off * s,
                   pos[:, 1:] + along * s + off * c], axis=2)
    return {**out, "waypoints": wp, "dest": wp[:, 0].copy()}
