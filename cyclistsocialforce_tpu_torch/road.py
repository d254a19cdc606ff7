"""Road infrastructure geometry of the PyTorch port: segments, edges,
collections (counterpart of `cyclistsocialforce_tpu.road`, the same numpy
geometry).

Host-side builders for the road-edge repulsion consumed by the engine
(`ops.forces.road_edge_force`). Port of the reference geometry classes
RoadSegment / StraightRoadSegment / CurvedRoadSegment /
RoadSegmentCollection / RoadEdge (reference intersection.py:32-250): a
segment is two polyline edges offset +/- width/2 from the centerline,
discretized every `ds` meters; every vertex repels road users with
magnitude F_0 * r^-sigma (intersection.py:226-242).

Geometry construction is numpy on the host (scenario setup); only the
stacked vertex array goes to the device, where the force is one
[N_agents, V_total] evaluation instead of the reference's per-edge
Python loop (intersection.py:45-47, 85-93).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.engine import RoadElements
from cyclistsocialforce_tpu_torch.params import RoadElementParams


@dataclass
class RoadSegment:
    """One road segment: two edge polylines + entry/exit poses."""

    x0: np.ndarray                     # [3] entry pose (x, y, heading)
    x1: np.ndarray                     # [3] exit pose
    width: float
    vertices_right: np.ndarray         # [Vr, 2]
    vertices_left: np.ndarray          # [Vl, 2]
    params: RoadElementParams = field(default_factory=RoadElementParams)

    @property
    def edges(self):
        return (self.vertices_right, self.vertices_left)


def straight_segment(x0, width, length, ds=0.1,
                     params=None) -> RoadSegment:
    """Straight segment from pose x0 = (x, y, heading)
    (reference StraightRoadSegment, intersection.py:118-147)."""
    x0 = np.asarray(x0, dtype=float)
    s = np.arange(0, length + ds, ds)
    R = np.array([[np.cos(x0[2]), -np.sin(x0[2])],
                  [np.sin(x0[2]), np.cos(x0[2])]])
    vert_r = (R @ np.c_[s, -(width / 2) * np.ones_like(s)].T).T + x0[:2]
    vert_l = (R @ np.c_[s, (width / 2) * np.ones_like(s)].T).T + x0[:2]
    x1 = np.array([*(x0[:2] + length * np.array([np.cos(x0[2]),
                                                 np.sin(x0[2])])), x0[2]])
    return RoadSegment(x0=x0, x1=x1, width=width, vertices_right=vert_r,
                       vertices_left=vert_l,
                       params=params or RoadElementParams())


def curved_segment(x0, width, radius, angle, direction, ds=0.1,
                   params=None) -> RoadSegment:
    """Circular-arc segment turning `angle` rad to the given direction
    (reference CurvedRoadSegment, intersection.py:149-211)."""
    x0 = np.asarray(x0, dtype=float)
    if direction == "left":
        d = 1.0
    elif direction == "right":
        d = -1.0
    else:
        raise ValueError(
            f'direction has to be "left" or "right", got {direction}')

    beta = x0[2] - np.pi / 2
    R = np.array([[np.cos(beta), -np.sin(beta)],
                  [np.sin(beta), np.cos(beta)]])

    def arc(r_edge):
        n = int(r_edge * angle / ds)
        ang = np.linspace(0, angle, n)
        xs = d * (r_edge * np.cos(ang) - radius)
        ys = r_edge * np.sin(ang)
        return (R @ np.c_[xs, ys].T).T + x0[:2]

    vert_r = arc(radius + d * width / 2)
    vert_l = arc(radius - d * width / 2)
    end = np.array([d * (radius * np.cos(angle) - radius),
                    radius * np.sin(angle)])
    x1 = np.array([*((R @ end) + x0[:2]), x0[2] + d * angle])
    return RoadSegment(x0=x0, x1=x1, width=width, vertices_right=vert_r,
                       vertices_left=vert_l,
                       params=params or RoadElementParams())


@dataclass
class RoadSegmentCollection:
    """Chainable list of segments (reference intersection.py:32-69)."""

    segs: list

    @classmethod
    def chain(cls, x0, pieces, width, ds=0.1, params=None):
        """Build consecutive segments, each starting at the previous end.

        `pieces` is a list of ("straight", length) or
        ("curve", radius, angle, direction) tuples.
        """
        segs = []
        pose = np.asarray(x0, dtype=float)
        for piece in pieces:
            kind = piece[0]
            if kind == "straight":
                seg = straight_segment(pose, width, piece[1], ds, params)
            elif kind == "curve":
                seg = curved_segment(pose, width, piece[1], piece[2],
                                     piece[3], ds, params)
            else:
                raise ValueError(f"unknown piece kind {kind}")
            segs.append(seg)
            pose = seg.x1
        return cls(segs)

    def destinations(self):
        """Segment end points as a destination sequence (reference
        get_destinations_from_segments, intersection.py:53-56)."""
        return ([s.x1[0] for s in self.segs], [s.x1[1] for s in self.segs])

    def __getitem__(self, i):
        return self.segs[i]

    def __len__(self):
        return len(self.segs)


def build_road_elements(segments, dtype=torch.float64,
                        device="cuda") -> RoadElements:
    """Stack segment edges into the engine's RoadElements, tensors of
    `dtype` on `device`.

    Accepts RoadSegment / RoadSegmentCollection instances (mixed ok).
    Per-vertex F_0/sigma come from each segment's params, so segments with
    different repulsion parameters coexist in one evaluation.
    """
    verts, f0s, sigmas = [], [], []
    flat = []
    for s in segments:
        flat.extend(s.segs if isinstance(s, RoadSegmentCollection) else [s])
    for seg in flat:
        for edge in seg.edges:
            v = np.asarray(edge, dtype=np.float64)
            verts.append(v)
            f0s.append(np.full(v.shape[0], float(seg.params.F_0)))
            sigmas.append(np.full(v.shape[0], float(seg.params.sigma)))
    if not verts:
        raise ValueError("no road segments given")
    vertices = np.concatenate(verts, axis=0)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return RoadElements(vertices=t(vertices),
                        weights=t(np.ones(vertices.shape[0])),
                        F_0=t(np.concatenate(f0s)),
                        sigma=t(np.concatenate(sigmas)))
