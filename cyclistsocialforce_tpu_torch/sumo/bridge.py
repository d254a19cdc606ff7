"""SUMO co-simulation bridge: intersections with dynamic populations
(counterpart of `cyclistsocialforce_tpu.sumo.bridge`; reference
intersection.py:333-539, 660-688, scenario.py:268-482).

SUMO simulates road users on links; whenever one enters a junction's
internal lanes it is handed to the social-force engine, rides the
intersection under social forces along a route-spline destination
prototype, and is handed back once SUMO maps its pushed position onto
the outgoing edge.

Each intersection owns a fixed-capacity slot population on `device`
(`AgentState` rows and the `active` mask) in float64, as the JAX package
makes it: a handover writes one slot in place, and the engine steps the
whole population (inactive rows neither receive nor emit a force). The
host reads the state back once per junction per step for all of its
`moveToXY` pushes. With a `NeighborConfig` the pair stage is the culled
one: K1 on the card (its packs cast to float32 there), the plain culled
version on the CPU; on the card a junction's step is then one replay of
a CUDA graph after an eager table build (an `engine.ChunkRunner` of one
step, captured at the junction's first occupied step: the port's
counterpart of JAX's jitted step), the same step as `Engine.step`. The
transport is injected (traci, libsumo or `FakeTraCI`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.engine import ChunkRunner, Engine
from cyclistsocialforce_tpu_torch.models import MODELS
from cyclistsocialforce_tpu_torch.params import (BalancingRiderParams,
                                                 BicycleParams,
                                                 InvPendulumBicycleParams,
                                                 as_population)
from cyclistsocialforce_tpu_torch.state import make_state, set_destinations
from cyclistsocialforce_tpu_torch.sumo.net import SumoNetwork
from cyclistsocialforce_tpu_torch.sumo.transport import (
    angle_sfm_to_sumo_float, angle_sumo_to_sfm_float)
from cyclistsocialforce_tpu_torch.trajectory import generate_spline_prototype

# vehicle factory by bicycle_type string (reference scenario.py:416-429)
BICYCLE_TYPES = {
    "bicycle": ("bicycle2d", BicycleParams),
    "twowheeler": ("twod", InvPendulumBicycleParams),
    "invpendulum": ("invpendulum", InvPendulumBicycleParams),
    "balancingrider": ("balancingrider", BalancingRiderParams),
}

# the latents a model's `prepare` places, written for the entering slot
_LATENTS = ("dyn_x", "dyn_v", "dyn_gains", "zrid", "walk_ok_steps")


def _graphed(engine, state) -> bool:
    """Does a junction's step run as a replay of a captured step: on the
    card, with a neighbor table (the dense stage steps eagerly)."""
    return engine.neighbors is not None and state.s.is_cuda


class SumoIntersection:
    """One junction's social-force space with SUMO handover (reference
    SocialForceIntersection SUMO branch, intersection.py:333-539)."""

    def __init__(self, net: SumoNetwork, junction, model_name="bicycle2d",
                 params=None, capacity=32, t_s=0.01, queue_size=16,
                 neighbors=None, device="cuda"):
        self.net = net
        self.junction = junction
        self.id = junction.id
        self.capacity = capacity
        self.model = MODELS[model_name]
        if params is None:
            # the default params class follows the model (the balancing
            # rider needs br_* fields that BicycleParams lacks)
            by_model = {m: c for m, c in BICYCLE_TYPES.values()}
            params = by_model.get(model_name, BicycleParams).create(t_s=t_s)
        self.params = as_population(params, capacity, device)

        self.internal_lane_ids = net.internal_lane_ids(junction.id)
        if not self.internal_lane_ids:
            raise ValueError(
                f"Intersection {self.id} does not have internal lanes! "
                f"The co-simulation requires internal lanes to allocate "
                f"SUMO road users to intersections.")
        self.in_edges = {e.id: net.lane_end_points(e, incoming=True)
                         for e in net.incoming_edges(junction.id)}
        self.out_edges = {e.id: net.lane_end_points(e, incoming=False)
                          for e in net.outgoing_edges(junction.id)}

        st = make_state(np.zeros((capacity, 8)), queue_size=queue_size,
                        dtype=torch.float64, device=device)
        self.state = st.replace(active=torch.zeros(
            (capacity,), dtype=torch.bool, device=device))
        # the dense pair stage by default (tens of agents per junction);
        # a NeighborConfig selects the culled one for high capacities
        self.engine = Engine.create(self.params, self.model,
                                    neighbors=neighbors)
        self._slots: dict[str, int] = {}
        self._rng = np.random.default_rng(0)
        # a fresh random-stream identity for each entrant (state.uid keys
        # the stochastic streams; a recycled slot must not resume the
        # previous occupant's stream)
        self._next_uid = capacity

    # ---- handover bookkeeping ----

    def road_user_ids(self):
        return list(self._slots)

    def find_entered_exited(self, transport):
        """Diff the internal lanes' occupancy against the tracked users
        (reference find_entered_exited_roadusers,
        intersection.py:429-453)."""
        current = []
        for lid in self.internal_lane_ids:
            current += list(transport.lane.getLastStepVehicleIDs(lid))
        prev = set(self._slots)
        cur = set(current)
        return sorted(cur - prev), sorted(prev - cur)

    def _free_slot(self):
        used = set(self._slots.values())
        for k in range(self.capacity):
            if k not in used:
                return k
        raise RuntimeError(
            f"Intersection {self.id}: capacity {self.capacity} exceeded.")

    def add_road_user(self, vid, transport):
        """Pull the SUMO state, build the route-spline destination
        prototype and activate a slot (reference add_road_user,
        intersection.py:458-539, scenario.py:394-435)."""
        route = transport.vehicle.getRoute(vid)
        idx = transport.vehicle.getRouteIndex(vid)
        route = route[idx:]
        if len(route) < 2:
            raise ValueError(
                f"Road user {vid} does not have a valid remaining route "
                f"with more than one element: {route}")
        pos = transport.vehicle.getPosition(vid)
        psi = angle_sumo_to_sfm_float(transport.vehicle.getAngle(vid))
        v = transport.vehicle.getSpeed(vid)

        e_in, e_out = route[0], route[1]
        assert e_in in self.in_edges, \
            f"Road user {vid} arriving on junction {self.id} from " \
            f"unknown edge {e_in}!"
        assert e_out in self.out_edges, \
            f"Road user {vid} requesting to depart junction {self.id} " \
            f"on unknown edge {e_out}!"

        # closest incoming lane, random outgoing lane
        # (intersection.py:486-500)
        lanes_in = self.in_edges[e_in]
        if len(lanes_in) > 1:
            pts = np.array([(x[-1], y[-1]) for x, y in lanes_in])
            lane_in = int(np.argmin(np.hypot(pts[:, 0] - pos[0],
                                             pts[:, 1] - pos[1])))
        else:
            lane_in = 0
        lane_out = int(self._rng.integers(0, len(self.out_edges[e_out])))

        xi, yi = lanes_in[lane_in]
        xo, yo = self.out_edges[e_out][lane_out]
        xp, yp = generate_spline_prototype(np.concatenate([xi, xo]),
                                           np.concatenate([yi, yo]), 5)
        # drop the prototype points already behind the user
        # (intersection.py:513-519)
        dp2f = np.hypot(xp - xp[-1], yp - yp[-1])
        du2f = np.hypot(pos[0] - xp[-1], pos[1] - yp[-1])
        keep = dp2f < du2f
        xp, yp = xp[keep], yp[keep]
        if xp.size == 0:
            xp, yp = np.array([xo[-1]]), np.array([yo[-1]])

        slot = self._free_slot()
        st = self.state
        row = torch.zeros((8,), dtype=st.s.dtype, device=st.device)
        row[:4] = torch.tensor([pos[0], pos[1], psi, v], dtype=st.s.dtype)
        st.s[slot] = row
        st.active[slot] = True
        st.i[slot] = 0
        st.pos_hist[slot] = row[:2]
        st.znav[slot] = torch.tensor([True, False, False])
        st.znavparams[slot] = 0.0
        st.pid_e[slot] = 0.0
        st.pid_i[slot] = 0.0
        st.uid[slot] = self._next_uid
        self._next_uid += 1
        st = set_destinations(st, slot, xp, yp, reset=True)
        # the model's latents, for the new slot only
        prep = getattr(self.model, "prepare", None)
        if prep is not None:
            prepared = prep(self.params, st)
            for name in _LATENTS:
                getattr(st, name)[slot] = getattr(prepared, name)[slot]
        self.state = st
        self._slots[vid] = slot

    def remove_road_users(self, vids):
        """Deactivate exited users (reference remove_road_users_by_id)."""
        for vid in vids:
            slot = self._slots.pop(vid, None)
            if slot is not None:
                self.state.active[slot] = False

    # ---- stepping and push ----

    def step(self):
        """One engine step of the junction's population, when it holds a
        road user. The state a graph replay returns lives in the runner's
        static buffers until the next replay, which reads it first."""
        if not self._slots:
            return
        if not _graphed(self.engine, self.state):
            self.state = self.engine.step(self.state)
            return
        cache = self.engine.neighbor_cache(self.state)
        runner = self.engine._chunk_runner(ChunkRunner, self.state, cache,
                                           1, False, None)
        self.state, _ = runner.run(self.state, cache)

    def push_positions(self, transport):
        """Read the state back once, then push every position to SUMO
        (reference update_road_user_positions, intersection.py:660-688)."""
        if not self._slots:
            return
        s = self.state.s[:, :3].cpu().numpy()    # one device-to-host copy
        for vid, slot in self._slots.items():
            transport.vehicle.moveToXY(
                vid, "", -1, float(s[slot, 0]), float(s[slot, 1]),
                angle=angle_sfm_to_sumo_float(s[slot, 2]), keepRoute=6)


class SumoCoSimulation:
    """The SUMOScenario equivalent (reference scenario.py:268-482).
    `device` holds every intersection's population (the card unless the
    caller asks for the CPU)."""

    def __init__(self, net: SumoNetwork, transport, bicycle_type="bicycle",
                 t_s=0.01, capacity=32, run_time_factor=None,
                 params=None, neighbors=None, device="cuda"):
        self.net = net
        self.transport = transport
        self.t_s = t_s
        self.run_time_factor = run_time_factor
        model_name, params_cls = BICYCLE_TYPES[bicycle_type]
        base = params or params_cls.create(t_s=t_s)
        self.intersections = [
            SumoIntersection(net, j, model_name=model_name, params=base,
                             capacity=capacity, t_s=t_s,
                             neighbors=neighbors, device=device)
            for j in net.non_dead_end_junctions()]
        self.hist_run_time: list[float] = []

    def allocate_road_users(self):
        """Hand users over at every intersection (reference
        allocate_road_users, scenario.py:376-435)."""
        for ins in self.intersections:
            entered, exited = ins.find_entered_exited(self.transport)
            ins.remove_road_users(exited)
            for vid in entered:
                ins.add_road_user(vid, self.transport)

    def step(self):
        t0 = time.perf_counter()
        self.allocate_road_users()
        for ins in self.intersections:
            ins.step()
            ins.push_positions(self.transport)
        self.transport.simulationStep()
        dt = time.perf_counter() - t0
        if self.run_time_factor is not None:
            budget = self.t_s * self.run_time_factor
            if dt < budget:
                time.sleep(budget - dt)
        self.hist_run_time.append(time.perf_counter() - t0)

    def run(self, n_steps=None):
        """Run until SUMO expects no more vehicles (reference
        scenario.py:468-482)."""
        i = 0
        try:
            while self.transport.simulation.getMinExpectedNumber() > 0:
                if n_steps is not None and i >= n_steps:
                    break
                self.step()
                i += 1
        finally:
            self.transport.close()
        return i
