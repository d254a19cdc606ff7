"""PyTorch port: the road (`road.py`, `params.RoadElementParams`,
`engine.RoadElements`, `ops.forces.road_edge_force`, `Engine.create(road=)`
and `MixedEngine.create(road=)`) held to the JAX package in float64 on the
CPU, and the reference's curve golden.

The geometry builders equal JAX's as numpy (straight, curved left and
right, a chained collection and its destinations, the stacked vertices
and per-vertex F_0 and sigma); `road_edge_force` within 1e-12 of JAX's,
in one vertex chunk and in many; engines with a road, dense and culled,
and a `MixedEngine` with a road, against JAX's at 1e-9 m; and golden
`curve_balancingrider.npz` (tests/test_parity_curve.py) at that test's own
bars: 1e-8 m and forces within 1e-8 over 1,500 steps, 0.2 m over 2,500
and at the end. `Engine.create` takes `road=` beside `scripted=`, as
`MixedEngine.create` does.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch import road as TR  # noqa: E402
from cyclistsocialforce_tpu_torch.mixed import (MixedEngine,  # noqa: E402
                                                prepare_groups)
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import forces as F  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BalancingRiderParams, BicycleParams, RoadElementParams, as_population)
from cyclistsocialforce_tpu_torch.state import (make_state,  # noqa: E402
                                                set_destinations)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
# the curve scenario's road (tests/test_parity_curve.py)
CURVE = ((0.0, -20.0, np.pi / 2),
         [("straight", 25.0), ("curve", 10.0, np.pi / 2, "right"),
          ("curve", 10.0, np.pi / 2, "left"), ("straight", 20.0)])


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import parity_common

    from cyclistsocialforce_tpu import engine, make_state, mixed, params
    from cyclistsocialforce_tpu import road
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import prepare as jprepare
    from cyclistsocialforce_tpu.ops import forces
    from cyclistsocialforce_tpu.state import set_destinations as jset

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JE=engine, JP=params, JM=mixed, JR=road,
        JF=forces, make_state=make_state, MODELS=JMODELS, prepare=jprepare,
        set_destinations=jset, pc=parity_common)


def curve_collection(mod, params):
    return mod.RoadSegmentCollection.chain(*CURVE, width=5.0, params=params)


def test_engine_create_takes_road_and_refuses_scripted():
    """`Engine.create(road=...)` keeps the road, and `scripted=` takes a
    `ScriptedTraj` beside it; anything else given as `scripted` is
    refused with a TypeError. `MixedEngine.create` the same."""
    road = TR.build_road_elements([TR.straight_segment((0, 0, 0), 4, 10)],
                                  device=DEV)
    p = BicycleParams.create()
    sc = TE.ScriptedTraj.create(2, {1: np.zeros((3, 4))}, device=DEV)
    eng = TE.Engine.create(p, MODELS["bicycle2d"], road=road, scripted=sc)
    assert eng.road is road and eng.scripted is sc
    assert eng.with_params(p).road is road
    assert eng.with_params(p).scripted is sc
    with pytest.raises(TypeError, match="ScriptedTraj"):
        TE.Engine.create(p, MODELS["bicycle2d"], scripted=object())
    mixed = MixedEngine.create([("bicycle2d", p, 2)], road=road,
                               scripted=sc)
    assert mixed.road is road and mixed.scripted is sc
    with pytest.raises(TypeError, match="ScriptedTraj"):
        MixedEngine.create([("bicycle2d", p, 2)], scripted=object())


@pytest.mark.parametrize("direction", ["left", "right"])
def test_geometry_matches_jax(jx, direction):
    """straight_segment, curved_segment, RoadSegmentCollection.chain, its
    destinations and build_road_elements: JAX's arrays exactly."""
    jp = jx.JP.RoadElementParams.create(F_0=0.15, sigma=2.0)
    tp = RoadElementParams.create(F_0=0.15, sigma=2.0)
    pairs = [(TR.straight_segment((0.0, 1.0, 0.3), 4.0, 20.0, 0.1, tp),
              jx.JR.straight_segment((0.0, 1.0, 0.3), 4.0, 20.0, 0.1, jp)),
             (TR.curved_segment((1.0, -2.0, 0.7), 4.0, 10.0, np.pi / 2,
                                direction, 0.1, tp),
              jx.JR.curved_segment((1.0, -2.0, 0.7), 4.0, 10.0, np.pi / 2,
                                   direction, 0.1, jp))]
    for got, want in pairs:
        for f in ("x0", "x1", "vertices_right", "vertices_left"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), f)
        assert got.width == want.width
    coll = curve_collection(TR, tp)
    jcoll = curve_collection(jx.JR, jp)
    assert len(coll) == len(jcoll) == 4
    np.testing.assert_array_equal(np.asarray(coll.destinations()),
                                  np.asarray(jcoll.destinations()))
    road = TR.build_road_elements([coll, pairs[1][0]], device=DEV)
    jroad = jx.JR.build_road_elements([jcoll, pairs[1][1]])
    for f in ("vertices", "weights", "F_0", "sigma"):
        np.testing.assert_array_equal(getattr(road, f).numpy(),
                                      np.asarray(getattr(jroad, f)), f)
    conv = convert.road_from_jax(jroad, DEV)
    for f in ("vertices", "weights", "F_0", "sigma"):
        assert torch.equal(getattr(conv, f), getattr(road, f)), f
    with pytest.raises(ValueError):
        TR.curved_segment((0, 0, 0), 4.0, 10.0, 1.0, "up")
    with pytest.raises(ValueError):
        TR.build_road_elements([], device=DEV)


@pytest.mark.parametrize("chunk", [None, 1000])
def test_road_edge_force_matches_jax(jx, monkeypatch, chunk):
    """`road_edge_force` on a grid around the curve road (points on
    vertices included: they take no force from their own vertex) and
    padded vertices of weight 0: JAX's within 1e-12, in one chunk and in
    chunks of 1000 elements."""
    if chunk is not None:
        monkeypatch.setattr(F, "ROAD_CHUNK_ELEMENTS", chunk)
    road = TR.build_road_elements([curve_collection(
        TR, RoadElementParams.create(F_0=0.15, sigma=2.0))], device=DEV)
    gx, gy = np.meshgrid(np.linspace(-10, 40, 23), np.linspace(-25, 30, 19))
    x = np.concatenate([gx.ravel(), road.vertices[:7, 0].numpy()])
    y = np.concatenate([gy.ravel(), road.vertices[:7, 1].numpy()])
    w = np.ones(road.weights.shape[0])
    w[-40:] = 0.0
    got = F.road_edge_force(torch.from_numpy(x), torch.from_numpy(y),
                            road.vertices, torch.from_numpy(w), road.F_0,
                            road.sigma)
    want = jx.JF.road_edge_force(jx.jnp.asarray(x), jx.jnp.asarray(y),
                                 jx.jnp.asarray(road.vertices.numpy()),
                                 jx.jnp.asarray(w),
                                 jx.jnp.asarray(road.F_0.numpy()),
                                 jx.jnp.asarray(road.sigma.numpy()))
    for g, wt in zip(got, want):
        wt = np.asarray(wt)
        np.testing.assert_allclose(g.numpy(), wt, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(wt).max()))
    shared = F.road_edge_force(torch.from_numpy(x), torch.from_numpy(y),
                               road.vertices, road.weights, 0.15, 2.0)
    full = F.road_edge_force(torch.from_numpy(x), torch.from_numpy(y),
                             road.vertices, road.weights, road.F_0,
                             road.sigma)
    for a, b in zip(shared, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14,
                                   atol=1e-14)


def road_crowd(n=40, seed=6):
    """n riders around a straight road along x (from (0, 0), 200 m, 10 m
    wide), heading +x at 3-5 m/s, destinations 150 m ahead: (s0, dests)."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, 40, n)
    s0[:, 1] = rng.uniform(-4, 4, n)
    s0[:, 2] = rng.uniform(-0.2, 0.2, n)
    s0[:, 3] = rng.uniform(3, 5, n)
    return s0, s0[:, 0] + 150.0


@pytest.mark.parametrize("culled", [False, True])
def test_engine_with_road_matches_jax(jx, culled):
    """bicycle2d riders between the edges of a straight road (F_0 0.15,
    sigma 2), 150 steps, dense and culled (K1's plain version, the JAX
    package's XLA pair path): every position within 1e-9 m and every
    state and force within 1e-9 of JAX's; the road changes the run."""
    s0, dx = road_crowd()
    seg_kw = dict(x0=(0.0, 0.0, 0.0), width=10.0, length=200.0, ds=0.5)
    jroad = jx.JR.build_road_elements([jx.JR.straight_segment(
        params=jx.JP.RoadElementParams.create(F_0=0.15, sigma=2.0),
        **seg_kw)])
    road = TR.build_road_elements([TR.straight_segment(
        params=RoadElementParams.create(F_0=0.15, sigma=2.0), **seg_kw)],
        device=DEV)
    cfg = dict(cutoff=30.0, block=128, block_src=64, kb=4, rebuild_every=5)
    jst = jx.make_state(s0, dtype=np.float64)
    st = make_state(s0, dtype=torch.float64, device=DEV)
    for a in range(len(s0)):
        jst = jx.set_destinations(jst, a, (dx[a],), (s0[a, 1],))
        st = set_destinations(st, a, (dx[a],), (s0[a, 1],))
    jneigh = (jx.JE.NeighborConfig(backend="xla", screen=False, **cfg)
              if culled else None)
    neigh = TE.NeighborConfig(screen=False, **cfg) if culled else None
    jeng = jx.JE.Engine.create(jx.JP.BicycleParams.create(),
                               jx.MODELS["bicycle2d"], road=jroad,
                               neighbors=jneigh)
    _, want = jx.jax.jit(lambda e, s: e.simulate(s, 150,
                                                 record_forces=True))(jeng,
                                                                      jst)
    eng = TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                           road=road, neighbors=neigh)
    _, got = eng.simulate(st, 150, record_forces=True)
    pos = np.hypot(*(got[0].numpy() - np.asarray(want[0]))[..., :2]
                   .transpose(2, 0, 1))
    assert pos.max() < 1e-9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)
    free = TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                            neighbors=neigh)
    _, alone = free.simulate(st, 150, record_forces=True)
    assert (alone[0] - got[0]).abs().max() > 1e-3


def test_mixed_engine_with_road_matches_jax(jx):
    """A `MixedEngine` of bicycle2d and balancing riders (gains_poly) on
    the straight road, 150 dense steps: every position within 1e-9 m."""
    s0, dx = road_crowd(12, 8)
    jroad = jx.JR.build_road_elements([jx.JR.straight_segment(
        (0.0, 0.0, 0.0), 10.0, 200.0, 0.5)])
    jst = jx.make_state(s0, dtype=np.float64)
    for a in range(len(s0)):
        jst = jx.set_destinations(jst, a, (dx[a],), (s0[a, 1],))
    groups = [("bicycle2d", jx.JP.BicycleParams.create(), 6),
              ("balancingrider", jx.JP.BalancingRiderParams.create(
                  gains_poly=16, verbose=False), 6)]
    jeng = jx.JM.MixedEngine.create(groups, road=jroad)
    jst = jx.JM.prepare_groups(jeng, jst)
    _, want = jx.jax.jit(lambda s: jeng.simulate(s, 150))(jst)
    eng = MixedEngine.create(convert.group_specs_from_jax(jeng, DEV),
                             road=convert.road_from_jax(jroad, DEV))
    fresh = jx.make_state(s0, dtype=np.float64)
    st = prepare_groups(eng, convert.state_from_jax(fresh.replace(
        destqueue=jst.destqueue, dest=jst.dest, nq=jst.nq), DEV))
    _, traj = eng.simulate(st, 150)
    want = np.asarray(want)
    pos = np.hypot(*(traj.numpy() - want)[..., :2].transpose(2, 0, 1))
    assert pos.max() < 1e-9


def test_curve_balancingrider_golden(jx):
    """tests/test_parity_curve.py on the port: the balancing rider along
    the curved road of the reference's curve scenario, 2,500 steps: within
    1e-8 m of the golden over the first 1,500 steps (its forces within
    1e-8), within 0.2 m over all of them, and at the end."""
    golden = jx.pc.load_golden("curve_balancingrider.npz")
    road = TR.build_road_elements([curve_collection(
        TR, RoadElementParams.create(F_0=0.15, sigma=2.0))], device=DEV)
    st = make_state(np.array([[0.0, -5, np.pi / 2, 5, 0, 0, 0, 0]]),
                    dtype=torch.float64, device=DEV)
    st = set_destinations(st, 0, golden["destx"], golden["desty"])
    params = as_population(BalancingRiderParams.create(v_desired_default=3.0),
                           1, DEV)
    model = MODELS["balancingrider"]
    st = prepare(model, params, st)
    n_steps = 2500
    _, (traj, fx, fy) = TE.Engine.create(params, model, road=road).simulate(
        st, n_steps, record_forces=True)
    traj, fx, fy = traj.numpy(), fx.numpy(), fy.numpy()
    ref = golden["traj_0"]
    perr = np.hypot(traj[:, 0, 0] - ref[0, 1:n_steps + 1],
                    traj[:, 0, 1] - ref[1, 1:n_steps + 1])
    assert np.max(perr[:1500]) < 1e-8, f"15 s err {np.max(perr[:1500])}"
    assert np.max(perr) < 0.2, f"end-to-end err {np.max(perr)}"
    np.testing.assert_allclose(fx[:1500, 0], golden["forces_0"][0, 1:1501],
                               atol=1e-8)
    np.testing.assert_allclose(fy[:1500, 0], golden["forces_0"][1, 1:1501],
                               atol=1e-8)
    d_end = np.hypot(traj[-1, 0, 0] - ref[0, n_steps],
                     traj[-1, 0, 1] - ref[1, n_steps])
    assert d_end < 0.2, f"endpoint differs by {d_end} m"
