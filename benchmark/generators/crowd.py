"""Closed-loop crowd traffic: one seeded population of riders, uniform over
a square at the mix's density, each with one destination uniform over the
same square.

The draws are those of the port's `scenarios.build_population` (numpy's
`default_rng`, in the same order: x, y, heading, speed, then the
destinations' x and y, every draw over all rows, pad rows included), with
the mix's seed in place of its fixed 0. The rows past `n_riders`, up to a
multiple of `pad_to`, are inactive padding.
"""

from __future__ import annotations

import numpy as np


def generate(mix: dict, seed: int) -> dict:
    """The inputs of one run: `s0` [rows, 5] (x, y, heading, speed, steer)
    and `dest` [rows, 2] as float64, `n_riders` active rows first."""
    n_riders = int(mix["n_riders"])
    pad_to = int(mix.get("pad_to") or 1)
    rows = -(-n_riders // pad_to) * pad_to
    half = 0.5 * float(np.sqrt(n_riders / float(mix["density_per_m2"])))
    rng = np.random.default_rng(int(seed))
    s0 = np.zeros((rows, 5))
    s0[:, 0] = rng.uniform(-half, half, rows)
    s0[:, 1] = rng.uniform(-half, half, rows)
    s0[:, 2] = rng.uniform(*mix["heading_rad"], rows)
    s0[:, 3] = rng.uniform(*mix["speed_mps"], rows)
    dest = np.zeros((rows, 2))
    dest[:, 0] = rng.uniform(-half, half, rows)
    dest[:, 1] = rng.uniform(-half, half, rows)
    return {"s0": s0, "dest": dest, "n_riders": n_riders, "rows": rows,
            "half_side_m": half}
