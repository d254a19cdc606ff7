"""Minimal SUMO network model parsed from net.xml (the port's own copy of
`cyclistsocialforce_tpu.sumo.net`: plain Python and numpy).

Replaces the reference's dependency on `sumolib.net.readNet`
(reference intersection.py:333-402): stdlib ElementTree parsing of the
elements the co-simulation actually consumes -- junctions (footprint,
type, internal lanes), edges (from/to, lane polylines), and connections
(incoming lane -> internal via lane -> outgoing lane).

Lane-endpoint extraction for route-spline generation reproduces the
reference's resampling: fit a parametric spline through the lane shape
(k = min(5, n-1) incoming / min(3, n-1) outgoing), resample 10 points,
keep the last/first two (intersection.py:344-377).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

#: Shipped network assets (the reference ships its demo nets under
#: demo/config/*, SURVEY.md section 2.8; ours live in package data so
#: demos/tests are self-contained): "threeleg" (T-junction, six turning
#: movements) and "grid2x2" (four crossing corridors / four junctions).
SUMO_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             "data", "sumo")


def packaged_net_path(name: str) -> str:
    """Absolute path of a shipped .net.xml ('threeleg', 'grid2x2')."""
    path = os.path.join(SUMO_DATA_DIR, f"{name}.net.xml")
    if not os.path.exists(path):
        avail = sorted(f[:-8] for f in os.listdir(SUMO_DATA_DIR)
                       if f.endswith(".net.xml"))
        raise FileNotFoundError(
            f"No packaged net {name!r}; available: {avail}")
    return path


def load_packaged_net(name: str) -> "SumoNetwork":
    """Parse one of the shipped networks."""
    return SumoNetwork.parse(packaged_net_path(name))


def _parse_shape(s):
    return np.array([[float(v) for v in p.split(",")][:2]
                     for p in s.strip().split(" ")]) if s else None


@dataclass
class Lane:
    id: str
    edge_id: str
    index: int
    shape: np.ndarray          # [P, 2]
    length: float
    speed: float

    def arclengths(self):
        d = np.linalg.norm(np.diff(self.shape, axis=0), axis=1)
        return np.concatenate([[0.0], np.cumsum(d)])

    def position_at(self, s):
        """(x, y, heading) at arc length s along the polyline."""
        arc = self.arclengths()
        s = float(np.clip(s, 0.0, arc[-1]))
        j = int(np.searchsorted(arc, s, side="right") - 1)
        j = min(j, len(arc) - 2)
        seg = self.shape[j + 1] - self.shape[j]
        seg_len = max(float(np.linalg.norm(seg)), 1e-12)
        t = (s - arc[j]) / seg_len
        p = self.shape[j] + t * seg
        heading = float(np.arctan2(seg[1], seg[0]))
        return p[0], p[1], heading

    def project(self, x, y):
        """(arc length, distance) of the closest polyline point to (x, y)."""
        arc = self.arclengths()
        best = (0.0, np.inf)
        for j in range(len(self.shape) - 1):
            a, b = self.shape[j], self.shape[j + 1]
            ab = b - a
            denom = max(float(ab @ ab), 1e-12)
            t = float(np.clip(((np.array([x, y]) - a) @ ab) / denom, 0, 1))
            p = a + t * ab
            d = float(np.hypot(p[0] - x, p[1] - y))
            if d < best[1]:
                best = (float(arc[j] + t * np.linalg.norm(ab)), d)
        return best


@dataclass
class Edge:
    id: str
    from_node: str | None
    to_node: str | None
    function: str
    lanes: list = field(default_factory=list)

    @property
    def is_internal(self):
        return self.function == "internal"


@dataclass
class Junction:
    id: str
    type: str
    x: float
    y: float
    shape: np.ndarray | None
    inc_lane_ids: list
    int_lane_ids: list


@dataclass
class Connection:
    from_edge: str
    to_edge: str
    from_lane: int
    to_lane: int
    via: str | None


class SumoNetwork:
    """Parsed SUMO network (the sumolib subset used by the bridge)."""

    def __init__(self, edges, junctions, connections):
        self.edges: dict[str, Edge] = edges
        self.junctions: dict[str, Junction] = junctions
        self.connections: list[Connection] = connections
        self.lanes: dict[str, Lane] = {
            ln.id: ln for e in edges.values() for ln in e.lanes}

    @classmethod
    def parse(cls, path_or_string):
        if "\n" in str(path_or_string) or "<net" in str(path_or_string):
            root = ET.fromstring(path_or_string)
        else:
            root = ET.parse(path_or_string).getroot()
        edges = {}
        for e in root.iter("edge"):
            edge = Edge(id=e.get("id"), from_node=e.get("from"),
                        to_node=e.get("to"),
                        function=e.get("function", "normal"))
            for ln in e.iter("lane"):
                shape = _parse_shape(ln.get("shape"))
                edge.lanes.append(Lane(
                    id=ln.get("id"), edge_id=edge.id,
                    index=int(ln.get("index", 0)), shape=shape,
                    length=float(ln.get("length", 0.0)),
                    speed=float(ln.get("speed", 13.89))))
            edges[edge.id] = edge
        junctions = {}
        for j in root.iter("junction"):
            if j.get("type") == "internal":
                continue
            junctions[j.get("id")] = Junction(
                id=j.get("id"), type=j.get("type"),
                x=float(j.get("x")), y=float(j.get("y")),
                shape=_parse_shape(j.get("shape")),
                inc_lane_ids=(j.get("incLanes") or "").split(),
                int_lane_ids=(j.get("intLanes") or "").split())
        connections = [Connection(
            from_edge=c.get("from"), to_edge=c.get("to"),
            from_lane=int(c.get("fromLane", 0)),
            to_lane=int(c.get("toLane", 0)), via=c.get("via"))
            for c in root.iter("connection")
            if c.get("from") and not c.get("from").startswith(":")]
        return cls(edges, junctions, connections)

    # ---- junction topology queries (reference intersection.py:333-402) --

    def incoming_edges(self, junction_id):
        return [e for e in self.edges.values()
                if not e.is_internal and e.to_node == junction_id]

    def outgoing_edges(self, junction_id):
        return [e for e in self.edges.values()
                if not e.is_internal and e.from_node == junction_id]

    def internal_lane_ids(self, junction_id):
        ids = []
        for e in self.edges.values():
            if e.is_internal and e.id.startswith(f":{junction_id}_"):
                ids += [ln.id for ln in e.lanes]
        return ids

    def non_dead_end_junctions(self):
        """Junctions hosting a social-force intersection (the reference
        skips dead ends, scenario.py:300-326)."""
        return [j for j in self.junctions.values()
                if j.type != "dead_end"]

    def via_lane(self, from_edge, to_edge):
        """Internal via-lane id connecting two edges (first match)."""
        for c in self.connections:
            if c.from_edge == from_edge and c.to_edge == to_edge and c.via:
                return c.via
        return None

    # ---- lane-end points for route splines ----

    def lane_end_points(self, edge: Edge, incoming: bool):
        """Per-lane 2-point endpoints near the junction, via the
        reference's spline resampling (intersection.py:344-377).

        Returns a list of (x[2], y[2]) per lane.
        """
        from scipy import interpolate

        out = []
        for ln in edge.lanes:
            path = ln.shape
            k = min(5 if incoming else 3, path.shape[0] - 1)
            tck, _ = interpolate.splprep((path[:, 0], path[:, 1]), s=0.0,
                                         k=k)
            xi, yi = interpolate.splev(np.linspace(0, 1, 10), tck)
            if incoming:
                out.append((xi[-2:], yi[-2:]))
            else:
                out.append((xi[:2], yi[:2]))
        return out
