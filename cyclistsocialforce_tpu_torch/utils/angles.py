"""Angle and vector math primitives (PyTorch).

Counterpart of `cyclistsocialforce_tpu.utils.angles`: the same branchless
formulas, in the same operation order, so that float64 results agree with
the JAX package to the last few ulps. All functions broadcast over
arbitrary leading axes and compute in the input tensor's dtype.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "limit_angle",
    "expand_angle",
    "angle_difference",
    "cart2polar",
    "polar2cart",
    "thresh",
    "limit_magnitude",
    "angle_sumo_to_sfm",
    "angle_sfm_to_sumo",
    "to_deg",
    "to_rad",
]

_TWO_PI = 2.0 * math.pi


def limit_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap an angle (rad) into [-pi, pi]: remove whole turns with a floor
    division, then fold the single remaining excess turn (reference
    utils.py:124-139)."""
    theta = theta - torch.floor(theta / _TWO_PI) * _TWO_PI
    theta = torch.where(theta > math.pi, theta - _TWO_PI, theta)
    theta = torch.where(theta < -math.pi, theta + _TWO_PI, theta)
    return theta


def expand_angle(theta: torch.Tensor) -> torch.Tensor:
    """An angle of [-pi, pi] in [0, 2 pi) (reference utils.py:142-148)."""
    return torch.where(theta < 0, _TWO_PI + theta, theta)


def angle_difference(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Signed smallest rotation `da` such that a1 + da lands on a2
    (mod 2 pi). The sign is picked by testing which of a1 -/+ da wraps
    closest to a2 (reference utils.py:151-182)."""
    da = torch.abs(a1 - a2)
    da = torch.where(da > math.pi, _TWO_PI - da, da)
    test_1 = torch.abs(limit_angle(a1 - da) - a2)
    test_2 = torch.abs(limit_angle(a1 + da) - a2)
    return torch.where(test_1 < test_2, -da, da)


def cart2polar(x: torch.Tensor, y: torch.Tensor):
    """Cartesian to polar: (rho, phi) with phi in [-pi, pi], as
    arccos(x / rho) with the sign of y (reference utils.py:185-194);
    rho == 0 gives NaN there as here."""
    rho = torch.sqrt(x * x + y * y)
    phi = torch.arccos(x / rho)
    return rho, torch.where(y < 0, -phi, phi)


def polar2cart(rho: torch.Tensor, phi: torch.Tensor):
    """Polar to cartesian (reference utils.py:197-201)."""
    return rho * torch.cos(phi), rho * torch.sin(phi)


def thresh(x: torch.Tensor, minmax) -> torch.Tensor:
    """Clip x into [minmax[0], minmax[1]] as max(min(x, hi), lo)
    (reference utils.py:204-227). Bounds may be floats or tensors."""
    return torch.clamp(torch.clamp(x, max=minmax[1]), min=minmax[0])


def limit_magnitude(x: torch.Tensor, y: torch.Tensor, r):
    """Rescale vectors (x, y) whose magnitude exceeds r down to magnitude
    r; vectors at or below the limit, and zero vectors, pass unchanged
    (reference utils.py:56-86)."""
    rin = torch.sqrt(x * x + y * y)
    exceed = rin > r
    denom = torch.where(rin > 0, rin, 1.0)
    scale = torch.where(exceed, r / denom, 1.0)
    return x * scale, y * scale


def to_deg(rad):
    """Radians to degrees (reference utils.py:101-102)."""
    return 360.0 * rad / _TWO_PI


def to_rad(deg):
    """Degrees to radians (reference utils.py:105-106)."""
    return _TWO_PI * deg / 360.0


def angle_sumo_to_sfm(theta_deg: torch.Tensor) -> torch.Tensor:
    """SUMO's angle convention (degrees, clockwise from north) to the
    model's (radians, counter-clockwise from east; reference
    utils.py:114-116)."""
    return limit_angle(math.pi / 2 - to_rad(theta_deg))


def angle_sfm_to_sumo(theta_rad: torch.Tensor) -> torch.Tensor:
    """The model's angle convention to SUMO's (reference
    utils.py:119-121)."""
    return to_deg(expand_angle(math.pi / 2 - theta_rad))
