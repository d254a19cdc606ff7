"""Transport multiplex: traci / libsumo / in-process fake (the port's own
copy of `cyclistsocialforce_tpu.sumo.transport`: plain Python).

Equivalent of the reference's `config.py` feature-detection globals
(reference config.py:12-45) plus the missing piece its tests never had: a
hermetic in-process SUMO substitute (`FakeTraCI`) exposing the exact API
subset the co-simulation crosses the socket for (SURVEY.md section 3.2):

    lane.getLastStepVehicleIDs, vehicle.getRoute / getRouteIndex /
    getPosition / getAngle / getSpeed / moveToXY, simulationStep,
    simulation.getMinExpectedNumber, close.

FakeTraCI moves vehicles along the parsed lane polylines at constant
speed, routes them through internal (via) lanes at junctions, and -- like
real SUMO under `moveToXY(keepRoute=6)` -- maps externally pushed
positions back onto the network, returning control to the mover once the
position projects onto the outgoing edge.
"""

from __future__ import annotations

import math

from cyclistsocialforce_tpu_torch.sumo.net import SumoNetwork
from cyclistsocialforce_tpu_torch.utils.angles import to_deg, to_rad

try:  # pragma: no cover - not installed in this environment
    import traci as _traci

    has_traci = True
except ImportError:
    _traci = None
    has_traci = False

try:  # pragma: no cover
    import libsumo as _libsumo

    has_libsumo = True
except ImportError:
    _libsumo = None
    has_libsumo = False

has_sumo = has_traci or has_libsumo

_TWO_PI = 2.0 * math.pi


def angle_sumo_to_sfm_float(theta_deg: float) -> float:
    """`utils.angles.angle_sumo_to_sfm` of one Python float, in float64
    with the same operations in the same order (the per-vehicle
    conversion on the host)."""
    theta = math.pi / 2 - to_rad(float(theta_deg))
    theta = theta - math.floor(theta / _TWO_PI) * _TWO_PI
    if theta > math.pi:
        theta -= _TWO_PI
    if theta < -math.pi:
        theta += _TWO_PI
    return theta


def angle_sfm_to_sumo_float(theta_rad: float) -> float:
    """`utils.angles.angle_sfm_to_sumo` of one Python float, in float64
    with the same operations in the same order."""
    theta = math.pi / 2 - float(theta_rad)
    if theta < 0:
        theta = _TWO_PI + theta
    return to_deg(theta)


def get_transport(prefer_libsumo=False, fake_net: SumoNetwork | None = None,
                  step_length=0.01):
    """Return the co-simulation transport: libsumo if preferred and
    available, else traci, else a FakeTraCI over `fake_net`
    (reference config.py:12-45 multiplexing + hermetic fallback)."""
    if prefer_libsumo and has_libsumo:
        return _libsumo
    if has_traci:
        return _traci
    if fake_net is not None:
        return FakeTraCI(fake_net, step_length=step_length)
    raise ImportError(
        "Neither traci nor libsumo is available; pass a SumoNetwork as "
        "fake_net to co-simulate against the in-process FakeTraCI.")


class _Vehicle:
    def __init__(self, vid, route, speed, depart=0.0):
        self.id = vid
        self.route = list(route)
        self.route_index = 0
        self.speed = float(speed)
        self.lane_id = None
        self.lane_pos = 0.0
        self.external = False
        self.x = self.y = 0.0
        self.heading = 0.0
        self.depart = float(depart)
        self.done = False


class FakeTraCI:
    """In-process SUMO-lite bound to a parsed `SumoNetwork`."""

    def __init__(self, net: SumoNetwork, step_length=0.01):
        self.net = net
        self.dt = float(step_length)
        self.time = 0.0
        self._vehicles: dict[str, _Vehicle] = {}
        self._pending: list[_Vehicle] = []
        # namespaced sub-APIs like the real traci module
        self.lane = _LaneAPI(self)
        self.vehicle = _VehicleAPI(self)
        self.simulation = _SimulationAPI(self)

    # ---- population management ----

    def add_vehicle(self, vid, route, speed, depart=0.0, depart_pos=0.0):
        v = _Vehicle(vid, route, speed, depart)
        v.lane_pos = float(depart_pos)
        if depart <= self.time:
            self._insert(v)
        else:
            self._pending.append(v)
        return v

    def _insert(self, v):
        edge = self.net.edges[v.route[0]]
        v.lane_id = edge.lanes[0].id
        self._sync_pose(v)
        self._vehicles[v.id] = v

    def _sync_pose(self, v):
        ln = self.net.lanes[v.lane_id]
        v.x, v.y, v.heading = ln.position_at(v.lane_pos)

    # ---- movement ----

    def _advance(self, v):
        v.lane_pos += v.speed * self.dt
        while True:
            ln = self.net.lanes[v.lane_id]
            length = ln.arclengths()[-1]
            if v.lane_pos <= length:
                break
            overshoot = v.lane_pos - length
            edge = self.net.edges[ln.edge_id]
            if edge.is_internal:
                # leave the junction onto the next route edge
                v.route_index += 1
                nxt = self.net.edges[v.route[v.route_index]]
                v.lane_id = nxt.lanes[0].id
            else:
                if v.route_index + 1 >= len(v.route):
                    v.done = True
                    return
                via = self.net.via_lane(v.route[v.route_index],
                                        v.route[v.route_index + 1])
                if via is not None:
                    v.lane_id = via
                else:
                    v.route_index += 1
                    nxt = self.net.edges[v.route[v.route_index]]
                    v.lane_id = nxt.lanes[0].id
            v.lane_pos = overshoot
        self._sync_pose(v)

    def simulationStep(self):
        self.time += self.dt
        for v in self._pending[:]:
            if v.depart <= self.time:
                self._pending.remove(v)
                self._insert(v)
        for v in list(self._vehicles.values()):
            if not v.external:
                self._advance(v)
            if v.done:
                del self._vehicles[v.id]

    def close(self):
        self._vehicles.clear()
        self._pending.clear()


class _LaneAPI:
    def __init__(self, t):
        self.t = t

    def getLastStepVehicleIDs(self, lane_id):
        return tuple(v.id for v in self.t._vehicles.values()
                     if v.lane_id == lane_id)


class _VehicleAPI:
    def __init__(self, t):
        self.t = t

    def _v(self, vid) -> _Vehicle:
        return self.t._vehicles[vid]

    def getRoute(self, vid):
        return tuple(self._v(vid).route)

    def getRouteIndex(self, vid):
        return self._v(vid).route_index

    def getPosition(self, vid):
        v = self._v(vid)
        return (v.x, v.y)

    def getAngle(self, vid):
        return angle_sfm_to_sumo_float(self._v(vid).heading)

    def getSpeed(self, vid):
        return self._v(vid).speed

    def moveToXY(self, vid, edge_id, lane_index, x, y, angle=None,
                 keepRoute=6):
        """External position push; maps back onto the outgoing edge when
        the position projects closer to it than to the internal lane
        (real SUMO's keepRoute=6 network mapping)."""
        v = self._v(vid)
        v.x, v.y = float(x), float(y)
        v.external = True
        cur = self.t.net.lanes[v.lane_id]
        if not self.t.net.edges[cur.edge_id].is_internal:
            return
        _, d_int = cur.project(v.x, v.y)
        if v.route_index + 1 < len(v.route):
            nxt_edge = self.t.net.edges[v.route[v.route_index + 1]]
            best = None
            for ln in nxt_edge.lanes:
                s, d = ln.project(v.x, v.y)
                if best is None or d < best[2]:
                    best = (ln.id, s, d)
            if best is not None and best[2] < d_int:
                v.lane_id, v.lane_pos = best[0], best[1]
                v.route_index += 1
                v.external = False
                self.t._sync_pose(v)


class _SimulationAPI:
    def __init__(self, t):
        self.t = t

    def getMinExpectedNumber(self):
        return len(self.t._vehicles) + len(self.t._pending)

    def getTime(self):
        return self.t.time
