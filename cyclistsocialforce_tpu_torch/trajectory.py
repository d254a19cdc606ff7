"""Trajectory prototype generation (counterpart of
`cyclistsocialforce_tpu.trajectory`, reference trajectory.py:11-41):
resample a cubic parametric spline through a few route support points,
the destination prototype a road user follows across an intersection.
Host-side scenario set-up with scipy's FITPACK, like the reference; the
spline destination force inside a step uses `ops.spline` instead."""

from __future__ import annotations

import numpy as np


def generate_spline_prototype(x, y, npoints=5):
    """Cubic-spline trajectory prototype through the support points.

    x, y : array-like of equal length >= 3 (with 3 points FITPACK drops
        to a quadratic, as in the reference).
    npoints : number of prototype points returned.

    Returns (xp, yp), numpy arrays of `npoints` values."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if x.shape != y.shape:
        raise ValueError("x and y must be same length!")
    if x.size < 3:
        raise ValueError(
            "Provide at least 3 points to calculate a trajectory prototype")
    from scipy import interpolate

    tck, _ = interpolate.splprep((x, y), s=0.0, k=min(3, x.size - 1))
    xp, yp = interpolate.splev(np.linspace(0.0, 1.0, npoints), tck)
    return xp, yp
