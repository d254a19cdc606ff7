"""Angle and vector math primitives (PyTorch).

Counterpart of `cyclistsocialforce_tpu.utils.angles`: the same branchless
formulas, in the same operation order, so that float64 results agree with
the JAX package to the last few ulps. All functions broadcast over
arbitrary leading axes and compute in the input tensor's dtype.
"""

from __future__ import annotations

import math

import torch

__all__ = ["limit_angle", "angle_difference", "thresh", "limit_magnitude"]

_TWO_PI = 2.0 * math.pi


def limit_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap an angle (rad) into [-pi, pi]: remove whole turns with a floor
    division, then fold the single remaining excess turn (reference
    utils.py:124-139)."""
    theta = theta - torch.floor(theta / _TWO_PI) * _TWO_PI
    theta = torch.where(theta > math.pi, theta - _TWO_PI, theta)
    theta = torch.where(theta < -math.pi, theta + _TWO_PI, theta)
    return theta


def angle_difference(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Signed smallest rotation `da` such that a1 + da lands on a2
    (mod 2 pi). The sign is picked by testing which of a1 -/+ da wraps
    closest to a2 (reference utils.py:151-182)."""
    da = torch.abs(a1 - a2)
    da = torch.where(da > math.pi, _TWO_PI - da, da)
    test_1 = torch.abs(limit_angle(a1 - da) - a2)
    test_2 = torch.abs(limit_angle(a1 + da) - a2)
    return torch.where(test_1 < test_2, -da, da)


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
