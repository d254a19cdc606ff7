"""PyTorch port: the SUMO co-simulation (`sumo/net.py`, `sumo/transport.py`,
`sumo/bridge.py`) held to the JAX package's on the same nets and the same
demand: the parsed networks and lane end points (1e-12), `FakeTraCI`'s
motion step for step, and the co-simulations of tests/test_sumo.py, each
recording every `moveToXY` push: the same vehicle at the same step in both
packages, positions within 1e-9 m (the JAX side in float64 on the CPU,
the port's dense or plain culled pair stage on the CPU). The card's run
is held to the CPU's in a `cuda`-marked test that skips here.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import NeighborConfig  # noqa: E402
from cyclistsocialforce_tpu_torch import sumo as TS  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
POS_TOL = 1e-9

# tests/test_sumo.py's 3-leg junction: west->east and south->east routes
# through internal lanes
NET_XML = """<?xml version="1.0" encoding="UTF-8"?>
<net version="1.16">
  <edge id=":J_0" function="internal">
    <lane id=":J_0_0" index="0" speed="10" length="16"
          shape="-8.00,0.00 8.00,0.00"/>
  </edge>
  <edge id=":J_1" function="internal">
    <lane id=":J_1_0" index="0" speed="8" length="13.5"
          shape="0.00,-8.00 1.00,-4.00 4.00,-1.00 8.00,0.00"/>
  </edge>
  <edge id="EW" from="JW" to="J" priority="1">
    <lane id="EW_0" index="0" speed="13.89" length="42"
          shape="-50.00,0.00 -8.00,0.00"/>
  </edge>
  <edge id="ES" from="JS" to="J" priority="1">
    <lane id="ES_0" index="0" speed="13.89" length="42"
          shape="0.00,-50.00 0.00,-8.00"/>
  </edge>
  <edge id="EE" from="J" to="JE" priority="1">
    <lane id="EE_0" index="0" speed="13.89" length="42"
          shape="8.00,0.00 50.00,0.00"/>
  </edge>
  <junction id="J" type="priority" x="0.00" y="0.00"
            incLanes="EW_0 ES_0" intLanes=":J_0_0 :J_1_0"
            shape="-8,2 8,2 8,-2 -8,-2"/>
  <junction id="JW" type="dead_end" x="-50" y="0" incLanes="" intLanes=""/>
  <junction id="JS" type="dead_end" x="0" y="-50" incLanes="" intLanes=""/>
  <junction id="JE" type="dead_end" x="50" y="0" incLanes="EE_0"
            intLanes=""/>
  <connection from="EW" to="EE" fromLane="0" toLane="0" via=":J_0_0"/>
  <connection from="ES" to="EE" fromLane="0" toLane="0" via=":J_1_0"/>
</net>
"""

THREELEG = [("b0", ("WJ", "JE"), 4.0, 48.0), ("b1", ("SJ", "JW"), 4.0, 48.0)]
GRID = [("a0", ("inA", "J00J10", "outA"), 5.0, 46.0),
        ("b0", ("inB", "J10J11", "outB"), 5.0, 46.0)]
ROUNDTRIP = [("b0", ("EW", "EE"), 4.0, 40.0)]
CROSSING = [("b0", ("EW", "EE"), 4.0, 38.0), ("b1", ("ES", "EE"), 4.0, 38.0)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's SUMO modules, the reference."""
    pytest.importorskip("jax")
    from cyclistsocialforce_tpu import sumo
    from cyclistsocialforce_tpu.engine import NeighborConfig as JNC

    return types.SimpleNamespace(sumo=sumo, NeighborConfig=JNC)


class Recording:
    """A transport that passes every call to `inner` and records each
    `moveToXY` push as (step, vehicle, x, y, angle)."""

    def __init__(self, inner):
        self.inner, self.pushes, self.step = inner, [], 0
        rec = self

        class _Vehicle:
            def __getattr__(self, name):
                return getattr(inner.vehicle, name)

            def moveToXY(self, vid, edge_id, lane_index, x, y, angle=None,
                         keepRoute=6):
                rec.pushes.append((rec.step, vid, x, y, angle))
                inner.vehicle.moveToXY(vid, edge_id, lane_index, x, y,
                                       angle=angle, keepRoute=keepRoute)

        self.vehicle = _Vehicle()
        self.lane, self.simulation = inner.lane, inner.simulation

    def simulationStep(self):
        self.step += 1
        self.inner.simulationStep()

    def close(self):
        self.inner.close()


def net_of(pkg, name):
    if name == "inline":
        return pkg.SumoNetwork.parse(NET_XML)
    return pkg.load_packaged_net(name)


def cosim(pkg, name, vehicles, max_steps, bicycle_type="bicycle",
          capacity=8, neighbors=None, **kw):
    """Run a co-simulation of `vehicles` (id, route, speed, depart_pos)
    on net `name` until SUMO expects no vehicle or `max_steps`; returns
    (pushes, steps, users seen per junction, the transport)."""
    net = net_of(pkg, name)
    t = pkg.FakeTraCI(net, step_length=0.01)
    for vid, route, speed, pos in vehicles:
        t.add_vehicle(vid, route, speed=speed, depart_pos=pos)
    rec = Recording(t)
    cs = pkg.SumoCoSimulation(net, rec, bicycle_type=bicycle_type,
                              capacity=capacity, neighbors=neighbors, **kw)
    seen = {ins.id: set() for ins in cs.intersections}
    n = 0
    while t.simulation.getMinExpectedNumber() > 0 and n < max_steps:
        cs.step()
        n += 1
        for ins in cs.intersections:
            seen[ins.id] |= set(ins.road_user_ids())
    return rec.pushes, n, seen, t


def assert_same_pushes(got, want):
    """The same (step, vehicle) sequence, positions within POS_TOL m and
    the SUMO angles within 1e-7 deg."""
    assert [p[:2] for p in got] == [p[:2] for p in want]
    g = np.array([p[2:] for p in got], dtype=float)
    w = np.array([p[2:] for p in want], dtype=float)
    np.testing.assert_allclose(g[:, :2], w[:, :2], rtol=0, atol=POS_TOL)
    d = np.abs(g[:, 2] - w[:, 2])
    np.testing.assert_array_less(np.minimum(d, 360.0 - d), 1e-7)


@pytest.mark.parametrize("name", ["inline", "threeleg", "grid2x2"])
def test_net_parses_as_jax(jx, name):
    a, b = net_of(TS, name), net_of(jx.sumo, name)
    assert list(a.junctions) == list(b.junctions)
    for jid, ja in a.junctions.items():
        jb = b.junctions[jid]
        assert (ja.type, ja.x, ja.y, ja.inc_lane_ids, ja.int_lane_ids) == (
            jb.type, jb.x, jb.y, jb.inc_lane_ids, jb.int_lane_ids)
        assert (ja.shape is None) == (jb.shape is None)
        if ja.shape is not None:
            np.testing.assert_array_equal(ja.shape, jb.shape)
        assert a.internal_lane_ids(jid) == b.internal_lane_ids(jid)
        assert ([e.id for e in a.incoming_edges(jid)]
                == [e.id for e in b.incoming_edges(jid)])
        assert ([e.id for e in a.outgoing_edges(jid)]
                == [e.id for e in b.outgoing_edges(jid)])
    assert list(a.lanes) == list(b.lanes)
    for lid, la in a.lanes.items():
        lb = b.lanes[lid]
        assert (la.edge_id, la.index, la.length, la.speed) == (
            lb.edge_id, lb.index, lb.length, lb.speed)
        np.testing.assert_array_equal(la.shape, lb.shape)
    assert [vars(c) for c in a.connections] == [vars(c)
                                               for c in b.connections]
    for c in a.connections:
        assert a.via_lane(c.from_edge, c.to_edge) == b.via_lane(
            c.from_edge, c.to_edge)
    assert ([j.id for j in a.non_dead_end_junctions()]
            == [j.id for j in b.non_dead_end_junctions()])
    for eid, ea in a.edges.items():
        if ea.is_internal:
            continue
        for incoming in (True, False):
            pa = a.lane_end_points(ea, incoming)
            pb = b.lane_end_points(b.edges[eid], incoming)
            np.testing.assert_allclose(np.asarray(pa), np.asarray(pb),
                                       rtol=0, atol=1e-12)


def test_packaged_net_path_is_the_ports_copy(jx):
    path = TS.packaged_net_path("grid2x2")
    assert "cyclistsocialforce_tpu_torch" in path
    with open(path) as f, open(jx.sumo.packaged_net_path("grid2x2")) as g:
        assert f.read() == g.read()
    with pytest.raises(FileNotFoundError):
        TS.packaged_net_path("nonexistent")


def test_fake_traci_moves_vehicles_as_jax(jx):
    """Both transports move the same vehicles step for step, through the
    via lanes, and drop them at the route's end alike."""
    fakes = []
    for pkg in (TS, jx.sumo):
        t = pkg.FakeTraCI(net_of(pkg, "grid2x2"), step_length=0.05)
        for k, (vid, route, speed, pos) in enumerate(GRID):
            t.add_vehicle(vid, route, speed=speed, depart=0.5 * k,
                          depart_pos=pos)
        fakes.append(t)
    for _ in range(900):
        rows = []
        for t in fakes:
            ids = sorted(t._vehicles)
            rows.append((ids, [t.vehicle.getPosition(v) for v in ids],
                         [t.vehicle.getAngle(v) for v in ids],
                         [t.vehicle.getRouteIndex(v) for v in ids],
                         [t.lane.getLastStepVehicleIDs(t._vehicles[v]
                                                       .lane_id)
                          for v in ids],
                         t.simulation.getMinExpectedNumber()))
            t.simulationStep()
        assert rows[0] == rows[1]
    assert all(t.simulation.getMinExpectedNumber() == 0 for t in fakes)


@pytest.mark.parametrize("case", ["threeleg", "grid2x2", "roundtrip",
                                  "crossing"])
def test_cosimulation_pushes_equal_jax(jx, case):
    """tests/test_sumo.py's co-simulations: every moveToXY push of the
    port equals JAX's (same vehicle, same step, 1e-9 m), and the riders
    enter the junctions of their routes and finish."""
    name, vehicles, steps = {
        "threeleg": ("threeleg", THREELEG, 6000),
        "grid2x2": ("grid2x2", GRID, 12000),
        "roundtrip": ("inline", ROUNDTRIP, 3000),
        "crossing": ("inline", CROSSING, 4000)}[case]
    got, n, seen, t = cosim(TS, name, vehicles, steps, device=DEV)
    want, n_j, seen_j, _ = cosim(jx.sumo, name, vehicles, steps)
    assert n == n_j and seen == seen_j
    assert t.simulation.getMinExpectedNumber() == 0
    assert_same_pushes(got, want)
    if case == "grid2x2":
        assert {"a0"} <= seen["J00"] and {"a0", "b0"} <= seen["J10"]
        assert {"b0"} <= seen["J11"]


@pytest.mark.parametrize("bicycle_type", ["twowheeler", "balancingrider"])
def test_cosimulation_models_with_latents_equal_jax(jx, bicycle_type):
    """The twod and balancing-rider riders (each entrant's latents
    written by `prepare` for its slot only) push what JAX's push."""
    got, n, seen, _ = cosim(TS, "inline", CROSSING, 4000,
                            bicycle_type=bicycle_type, device=DEV)
    want, n_j, seen_j, _ = cosim(jx.sumo, "inline", CROSSING, 4000,
                                 bicycle_type=bicycle_type)
    assert n == n_j and seen == seen_j
    assert_same_pushes(got, want)


def test_cosimulation_culled_equals_dense_and_jax(jx):
    """The culled pair stage (a table covering the junction: the port's
    plain culled version; JAX's "xla" backend) pushes what the dense one
    pushes, as tests/test_sumo.py:358-388 holds, and equals JAX's."""
    cfg = dict(cutoff=1e3, block=8, kb=2)
    dense, _, _, _ = cosim(TS, "inline", CROSSING, 4000,
                           bicycle_type="twowheeler", device=DEV)
    culled, _, _, _ = cosim(TS, "inline", CROSSING, 4000,
                            bicycle_type="twowheeler",
                            neighbors=NeighborConfig(**cfg), device=DEV)
    want, _, _, _ = cosim(jx.sumo, "inline", CROSSING, 4000,
                          bicycle_type="twowheeler",
                          neighbors=jx.NeighborConfig(**cfg, backend="xla"))
    assert_same_pushes(culled, dense)
    assert_same_pushes(culled, want)


def test_junction_step_through_static_buffers_equals_eager(monkeypatch):
    """The card's form of a junction step (an eager table build, then the
    step behind an `engine.ChunkRunner`'s static buffers, its output
    overwritten by the next run and written by the handovers in between)
    pushes exactly what the eager `Engine.step` pushes: on the CPU with
    the chunk called where the card replays its graph
    (test_torch_graph.py's `DirectRunner`)."""
    from test_torch_graph import DirectRunner

    from cyclistsocialforce_tpu_torch.sumo import bridge

    cfg = NeighborConfig(cutoff=100, block=64, block_src=32, kb=2)
    eager, n, seen, _ = cosim(TS, "inline", CROSSING, 4000, capacity=64,
                              neighbors=cfg, device=DEV)
    runs = []

    class Counted(DirectRunner):
        def run(self, state, cache):
            runs.append(self)
            return super().run(state, cache)

    monkeypatch.setattr(bridge, "ChunkRunner", Counted)
    monkeypatch.setattr(bridge, "_graphed",
                        lambda engine, state: engine.neighbors is not None)
    got, n_g, seen_g, _ = cosim(TS, "inline", CROSSING, 4000, capacity=64,
                                neighbors=cfg, device=DEV)
    assert (n_g, seen_g) == (n, seen)
    assert got == eager
    assert len(runs) > 300 and len(set(map(id, runs))) == 1


def test_culled_legacy_junction_with_inactive_rows():
    """A 64-slot junction on the legacy field through the culled stage
    (the card path's form: block 64, block_src 32, kb 2) with two riders
    and 62 inactive rows: the forces equal the dense stage's, inactive
    rows keep their state, and a slot's uid past the capacity reads the
    shared parameters."""
    net = TS.SumoNetwork.parse(NET_XML)
    t = TS.FakeTraCI(net, step_length=0.1)
    for vid, route, speed, pos in CROSSING:
        t.add_vehicle(vid, route, speed=speed, depart_pos=41.9)
    t.simulationStep()
    sims = [TS.SumoCoSimulation(net, t, capacity=64, neighbors=nb,
                                device=DEV)
            for nb in (None, NeighborConfig(cutoff=100, block=64,
                                            block_src=32, kb=2))]
    for cs in sims:
        cs.allocate_road_users()
    ins = [cs.intersections[0] for cs in sims]
    assert int(ins[0].state.active.sum()) == 2
    assert int(ins[0].state.uid.max()) >= 64
    forces = [i.engine.calc_forces(i.state)[:2] for i in ins]
    for a, b in zip(*forces):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    before = ins[1].state
    after = ins[1].engine.step(before)
    idle = ~before.active
    assert torch.equal(after.s[idle], before.s[idle])
    assert not torch.equal(after.s[before.active], before.s[before.active])


def test_capacity_and_internal_lane_errors_as_jax(jx):
    many = [(f"b{k}", ("EW", "EE"), 4.0, 41.9) for k in range(3)]
    for pkg, kw in ((TS, {"device": DEV}), (jx.sumo, {})):
        net = pkg.SumoNetwork.parse(NET_XML)
        t = pkg.FakeTraCI(net, step_length=0.1)
        for vid, route, speed, pos in many:
            t.add_vehicle(vid, route, speed=speed, depart_pos=pos)
        t.simulationStep()
        cs = pkg.SumoCoSimulation(net, t, capacity=2, **kw)
        with pytest.raises(RuntimeError, match="capacity 2 exceeded"):
            cs.allocate_road_users()
        bare = NET_XML.replace('intLanes=":J_0_0 :J_1_0"', 'intLanes=""')
        bare = bare.replace('id=":J_', 'id=":K_')
        with pytest.raises(ValueError, match="does not have internal lanes"):
            pkg.SumoCoSimulation(pkg.SumoNetwork.parse(bare), t, **kw)
    with pytest.raises(ImportError):
        TS.get_transport()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_cosimulation_matches_cpu(cuda_device):
    """The grid2x2 co-simulation on the card (K1, mixed form at block 64)
    pushes what the CPU run pushes: the same vehicles at the same steps,
    positions within 1e-3 m (the pair stage in float32 on the card)."""
    cfg = NeighborConfig(cutoff=100, block=64, block_src=32, kb=2)
    got, n, seen, _ = cosim(TS, "grid2x2", GRID, 12000, capacity=64,
                            neighbors=cfg, device=cuda_device)
    want, n_c, seen_c, _ = cosim(TS, "grid2x2", GRID, 12000, capacity=64,
                                 neighbors=cfg, device=DEV)
    assert n == n_c and seen == seen_c
    assert [p[:2] for p in got] == [p[:2] for p in want]
    g = np.array([p[2:4] for p in got])
    w = np.array([p[2:4] for p in want])
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


def test_float_angle_conversions_equal_jax(jx):
    """The bridge's per-vehicle angle conversions on Python floats equal
    JAX's (float64) bit for bit, and the port's tensor functions."""
    from cyclistsocialforce_tpu.utils import angles as JA

    from cyclistsocialforce_tpu_torch.sumo import transport as TT
    from cyclistsocialforce_tpu_torch.utils import angles as TA

    rng = np.random.default_rng(8)
    degs = np.r_[0.0, 90.0, 180.0, 270.0, 359.999, rng.uniform(-720, 720, 200)]
    rads = np.r_[0.0, np.pi, -np.pi, np.pi / 2, rng.uniform(-7, 7, 200)]
    for d in degs:
        got = TT.angle_sumo_to_sfm_float(d)
        assert got == float(JA.angle_sumo_to_sfm(d))
        assert got == float(TA.angle_sumo_to_sfm(torch.tensor(d)))
    for r in rads:
        got = TT.angle_sfm_to_sumo_float(r)
        assert got == float(JA.angle_sfm_to_sumo(r))
        assert got == float(TA.angle_sfm_to_sumo(torch.tensor(r)))
