"""PyTorch port: scripted (uncontrolled) agents, `engine.ScriptedTraj`
with `Engine.create(scripted=)` and `MixedEngine.create(scripted=)`,
held to the JAX package in float64 on the CPU at 1e-9.

Reference semantics (vehicle.py:920-987): a scripted agent replays its
prescribed trajectory, ignores every force, holds its last state when the
script ends, and still emits its repulsive field on the others. The five
cases of tests/test_scripted.py run through both packages; the
sorted-resident run equals the gather path within the port at the JAX
package's own bar (1e-12, tests/test_scripted.py:112-160).
The card's case (graphed against eager) is marked `cuda` and skips
without a card.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.mixed import MixedEngine  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, as_population)
from cyclistsocialforce_tpu_torch.state import (make_state,  # noqa: E402
                                                set_destinations)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = 1e-9
F64 = torch.float64


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax

    from cyclistsocialforce_tpu import engine, make_state, mixed, params
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import prepare as jprepare
    from cyclistsocialforce_tpu.state import set_destinations as jset

    return types.SimpleNamespace(jax=jax, JE=engine, JP=params, JM=mixed,
                                 make_state=make_state, MODELS=JMODELS,
                                 prepare=jprepare, set_destinations=jset)


# the crossing scene of tests/test_scripted.py: agent 0 a bike riding +x,
# agent 1 a car crossing its path from the side
CROSS_S0 = np.array([[0.0, 0.0, 0.0, 4.0, 0.0],
                     [20.0, -12.0, np.pi / 2, 3.0, 0.0]])
CROSS_DESTS = [((60.0,), (0.0,)), ((20.0,), (50.0,))]


def car_script(n_steps):
    t = np.arange(n_steps + 1) * 0.01
    return np.stack([np.full_like(t, 20.0), -12.0 + 3.0 * t,
                     np.full_like(t, np.pi / 2), np.full_like(t, 3.0)],
                    axis=1)


def port_run(s0, dests, scripts, n_steps, params_kw=None, **sim):
    """The port's dense bicycle2d run of tests/test_scripted.py's scenes:
    (final state, records)."""
    n = s0.shape[0]
    st = make_state(s0, dtype=F64, device=DEV)
    for a, (x, y) in enumerate(dests):
        st = set_destinations(st, a, x, y)
    p = as_population(BicycleParams.create(), n, device=DEV)
    if params_kw:
        p = p.replace(**{k: torch.tensor(v, dtype=F64)
                         for k, v in params_kw.items()})
    model = MODELS["bicycle2d"]
    st = prepare(model, p, st)
    sc = TE.ScriptedTraj.create(n, scripts, dtype=F64, device=DEV)
    return TE.Engine.create(p, model, scripted=sc).simulate(st, n_steps,
                                                            **sim)


def jax_run(jx, s0, dests, scripts, n_steps, params_kw=None, **sim):
    n = s0.shape[0]
    st = jx.make_state(s0, dtype=np.float64)
    for a, (x, y) in enumerate(dests):
        st = jx.set_destinations(st, a, x, y)
    p = jx.JP.as_population(jx.JP.BicycleParams.create(), n)
    if params_kw:
        p = p.replace(**{k: np.asarray(v) for k, v in params_kw.items()})
    model = jx.MODELS["bicycle2d"]
    st = jx.prepare(model, p, st)
    sc = jx.JE.ScriptedTraj.create(n, scripts, dtype=np.float64)
    eng = jx.JE.Engine.create(p, model, scripted=sc)
    return jx.jax.jit(lambda e, s: e.simulate(s, n_steps, **sim))(eng, st)


def records(out):
    recs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(r) if not isinstance(r, torch.Tensor)
            else r.numpy() for r in recs]


# car-like field parameters for the crossing car (per-agent heterogeneity)
CAR_FIELD = {"f_0": [7.0, 12.0], "sigma_1": [5.0, 8.0]}


def test_scripted_agent_replays_exactly(jx):
    """The car's states equal its script at every step (row t is the
    state after step t + 1, script index t + 1), and the whole run
    matches the JAX package's."""
    car = car_script(400)
    _, traj = port_run(CROSS_S0, CROSS_DESTS, {1: car}, 400, CAR_FIELD)
    traj = traj.numpy()
    np.testing.assert_allclose(traj[:, 1, :4], car[1:, :4], atol=1e-12)
    _, jtraj = jax_run(jx, CROSS_S0, CROSS_DESTS, {1: car}, 400, CAR_FIELD)
    np.testing.assert_allclose(traj, np.asarray(jtraj), atol=TOL)


def test_scripted_agent_holds_after_script_end(jx):
    """A 100-entry script over 200 steps: replayed up to step 99, then
    held at its last state, as in the JAX package."""
    short = car_script(400)[:100]
    _, traj = port_run(CROSS_S0, CROSS_DESTS, {1: short}, 200)
    traj = traj.numpy()
    np.testing.assert_allclose(traj[98, 1, :4], short[99, :4], atol=1e-12)
    np.testing.assert_allclose(traj[150, 1, :4], short[99, :4], atol=1e-12)
    np.testing.assert_array_equal(traj[99:, 1], traj[99:100, 1].repeat(
        101, axis=0))
    _, jtraj = jax_run(jx, CROSS_S0, CROSS_DESTS, {1: short}, 200)
    np.testing.assert_allclose(traj, np.asarray(jtraj), atol=TOL)


def test_scripted_agent_deflects_others(jx):
    """The crossing car's field pushes the bike off its straight line;
    without the script agent 1 is a bike riding to its own destination.
    Both runs match the JAX package's."""
    car = car_script(400)
    for scripts in ({1: car}, {}):
        _, traj = port_run(CROSS_S0, CROSS_DESTS, scripts, 400, CAR_FIELD)
        _, jtraj = jax_run(jx, CROSS_S0, CROSS_DESTS, scripts, 400,
                           CAR_FIELD)
        np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj),
                                   atol=TOL)
        if scripts:
            assert np.max(np.abs(traj.numpy()[:, 0, 1])) > 0.05
            assert np.all(np.isfinite(traj.numpy()))


def test_scripted_agent_ignores_forces(jx):
    """Scripted rows take zero total force (no destination force, so the
    clamp zeroes the repulsion) in a close head-on encounter."""
    s0 = np.array([[0.0, 0.0, 0.0, 4.0, 0.0], [6.0, 0.5, np.pi, 4.0, 0.0]])
    dests = [((60.0,), (0.0,)), ((-60.0,), (0.0,))]
    car = np.stack([6.0 - 0.04 * np.arange(101), np.full(101, 0.5),
                    np.full(101, np.pi), np.full(101, 4.0)], axis=1)
    _, out = port_run(s0, dests, {1: car}, 100, record_forces=True)
    traj, fx, fy = records(out)
    np.testing.assert_array_equal(fx[:, 1], 0.0)
    np.testing.assert_array_equal(fy[:, 1], 0.0)
    np.testing.assert_allclose(traj[:, 1, :4], car[1:, :4], atol=1e-12)
    assert np.abs(fx[:, 0]).max() > 0.1
    _, jout = jax_run(jx, s0, dests, {1: car}, 100, record_forces=True)
    for got, want in zip((traj, fx, fy), records(jout)):
        np.testing.assert_allclose(got, want, atol=TOL)


SR_N, SR_SCRIPTED, SR_T = 64, (5, 40), 25


def sr_scene():
    """tests/test_scripted.py's sorted-resident scene: 64 riders, two
    scripted on 25-step straight tracks, 30 steps (replay and hold, chunks
    of 4 and a remainder)."""
    rng = np.random.default_rng(3)
    s0 = np.zeros((SR_N, 5))
    s0[:, 0] = rng.uniform(-40, 40, SR_N)
    s0[:, 1] = rng.uniform(-40, 40, SR_N)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, SR_N)
    s0[:, 3] = rng.uniform(1, 6, SR_N)
    dests = [((rng.uniform(-50, 50),), (rng.uniform(-50, 50),))
             for _ in range(SR_N)]
    tracks = {}
    for a in SR_SCRIPTED:
        t = np.zeros((SR_T, 4))
        t[:, 0] = s0[a, 0] + 8 * 0.01 * np.arange(1, SR_T + 1)
        t[:, 1] = s0[a, 1]
        t[:, 3] = 8.0
        tracks[a] = t
    return s0, dests, tracks


def test_scripted_sorted_resident_matches_gather_path(jx):
    """Culled (block 16, a table every 4 steps): the sorted-resident run,
    whose rows live in cell-sorted order within a chunk, equals the
    gather path within the JAX test's 1e-12 (its integer and flag fields
    exactly), the replay following each scripted agent through the
    permutations; both match the JAX package's culled run (its "xla"
    path; the port's is each kernel's plain version) at 1e-9."""
    s0, dests, tracks = sr_scene()
    st = make_state(s0, dtype=F64, device=DEV)
    for a, (x, y) in enumerate(dests):
        st = set_destinations(st, a, x, y)
    sc = TE.ScriptedTraj.create(SR_N, tracks, dtype=F64, device=DEV)
    cfg = dict(cutoff=1e3, block=16, kb=4, rebuild_every=4)
    nbr = TE.NeighborConfig(**cfg)
    finals = {}
    for sr in (True, False):
        eng = TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                               scripted=sc, neighbors=nbr,
                               sorted_resident=sr)
        assert eng.sorted_resident is sr
        finals[sr] = eng.simulate(st, 30, record=False)[0]
    for f in TE._STATE_FIELDS:
        a, b = getattr(finals[True], f), getattr(finals[False], f)
        if a.is_floating_point():
            # the JAX test's bar: the CPU's vectorised pow in the legacy
            # excentricity may round a row an ulp differently by its
            # position in the vector
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12, err_msg=f)
        else:
            assert torch.equal(a, b), f
    np.testing.assert_allclose(finals[True].s[5, 0].item(),
                               tracks[5][-1, 0], rtol=0, atol=1e-12)

    jst = jx.make_state(s0, dtype=np.float64)
    for a, (x, y) in enumerate(dests):
        jst = jx.set_destinations(jst, a, x, y)
    jeng = jx.JE.Engine.create(
        jx.JP.BicycleParams.create(), jx.MODELS["bicycle2d"],
        scripted=jx.JE.ScriptedTraj.create(SR_N, tracks, dtype=np.float64),
        neighbors=jx.JE.NeighborConfig(backend="xla", **cfg))
    jfin, _ = jx.jax.jit(lambda e, s: e.simulate(s, 30, record=False))(
        jeng, jst)
    np.testing.assert_allclose(finals[True].s.numpy(), np.asarray(jfin.s),
                               atol=TOL)


def test_scripted_traj_create_and_convert(jx):
    """`ScriptedTraj.create` builds the JAX package's tables, and
    `convert.scripted_from_jax` carries them over."""
    _, _, tracks = sr_scene()
    sc = TE.ScriptedTraj.create(SR_N, tracks, dtype=F64, device=DEV)
    jsc = jx.JE.ScriptedTraj.create(SR_N, tracks, dtype=np.float64)
    conv = convert.scripted_from_jax(jsc, DEV)
    for f in ("traj", "mask", "length"):
        np.testing.assert_array_equal(getattr(sc, f).numpy(),
                                      np.asarray(getattr(jsc, f)))
        assert torch.equal(getattr(conv, f), getattr(sc, f))
    assert sc.traj.shape == (SR_N, SR_T, 8) and sc.traj.dtype == F64
    assert sc.mask.sum() == 2 and sc.length.dtype == torch.int32
    f32 = sc.to(torch.float32)
    assert f32.traj.dtype == torch.float32 and f32.mask is sc.mask
    with pytest.raises(TypeError, match="ScriptedTraj"):
        TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                         scripted={1: tracks[5]})


def test_scripts_must_cover_every_row():
    """Scripts built for fewer agents than the state has rows are
    refused when the engine first meets the state."""
    s0, dests, tracks = sr_scene()
    st = make_state(s0, dtype=F64, device=DEV)
    sc = TE.ScriptedTraj.create(SR_N - 1, {5: tracks[5]}, dtype=F64,
                                device=DEV)
    eng = TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                           scripted=sc)
    with pytest.raises(ValueError, match="padding rows included"):
        eng.step(st)


def test_with_params_and_assignment_keep_the_scripts():
    """`with_params` carries the scripts; assigning new ones empties the
    engine's kept tables, so the next step reads the new ones."""
    s0, dests, tracks = sr_scene()
    st = make_state(s0, dtype=F64, device=DEV)
    sc = TE.ScriptedTraj.create(SR_N, tracks, dtype=F64, device=DEV)
    eng = TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                           scripted=sc)
    assert eng.with_params(BicycleParams.create()).scripted is sc
    first = eng.step(st)
    np.testing.assert_allclose(first.s[40, :4].numpy(), tracks[40][1],
                               atol=1e-12)
    moved = {a: t + 1.0 for a, t in tracks.items()}
    eng.scripted = TE.ScriptedTraj.create(SR_N, moved, dtype=F64,
                                          device=DEV)
    np.testing.assert_allclose(eng.step(st).s[40, :4].numpy(),
                               moved[40][1], atol=1e-12)


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
def test_mixed_engine_scripted_matches_jax(jx, culled):
    """A MixedEngine of bicycle2d and twod riders with one scripted agent
    in each group, against the JAX package's MixedEngine: 120 steps,
    replay then hold (the scripts are 60 steps), at 1e-9; the scripted
    rows replay exactly."""
    n = 32
    rng = np.random.default_rng(21)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(-30, 30, n)
    s0[:, 1] = rng.uniform(-30, 30, n)
    s0[:, 2] = rng.uniform(-0.3, 0.3, n)
    s0[:, 3] = rng.uniform(3, 5, n)
    dests = [((float(s0[a, 0] + 60),), (float(s0[a, 1]),))
             for a in range(n)]
    tracks = {}
    for a in (3, n - 5):
        t = np.zeros((60, 4))
        t[:, 0] = s0[a, 0] + 5 * 0.01 * np.arange(1, 61)
        t[:, 1] = s0[a, 1] + 0.5 * np.sin(np.arange(1, 61) / 20)
        t[:, 3] = 5.0
        tracks[a] = t
    half = n // 2
    cfg = dict(cutoff=100.0, block=16, kb=2, rebuild_every=10)
    specs = [("bicycle2d", BicycleParams.create(), half),
             ("twod", BicycleParams.create(), n - half)]
    st = make_state(s0, dtype=F64, device=DEV)
    jst = jx.make_state(s0, dtype=np.float64)
    for a, (x, y) in enumerate(dests):
        st = set_destinations(st, a, x, y)
        jst = jx.set_destinations(jst, a, x, y)
    eng = MixedEngine.create(
        specs, scripted=TE.ScriptedTraj.create(n, tracks, dtype=F64,
                                               device=DEV),
        neighbors=TE.NeighborConfig(**cfg) if culled else None)
    jeng = jx.JM.MixedEngine.create(
        [(m, jx.JP.BicycleParams.create(), k) for m, _, k in specs],
        scripted=jx.JE.ScriptedTraj.create(n, tracks, dtype=np.float64),
        neighbors=(jx.JE.NeighborConfig(backend="xla", **cfg) if culled
                   else None))
    _, traj = eng.simulate(st, 120)
    _, jtraj = jx.jax.jit(lambda e, s: e.simulate(s, 120))(jeng, jst)
    traj = traj.numpy()
    np.testing.assert_allclose(traj, np.asarray(jtraj), atol=TOL)
    for a, t in tracks.items():
        np.testing.assert_allclose(traj[:59, a, :4], t[1:, :4], atol=1e-12)
        np.testing.assert_array_equal(traj[59:, a], traj[59:60, a].repeat(
            61, axis=0))
    # MixedEngine.step takes JAX's nbr_cache
    cache = eng.neighbor_cache(st) if culled else None
    np.testing.assert_array_equal(eng.step(st, cache).s.numpy(),
                                  eng.step(st).s.numpy())


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_scripted_graph_equals_eager(cuda_device):
    """Scripted riders in the bench-style crowd on the card: the graphed
    sorted-resident run equals the eager loop bit for bit, every scripted
    rider on its track (replay) or at its last point (hold)."""
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    st = build_population(4096, 0.02, 8, 128, torch.float32, cuda_device)
    n_steps, t_script = 45, 30
    s = st.s.cpu().numpy()
    tracks = {}
    for a in range(0, 4000, 97):
        t = np.zeros((t_script, 4))
        t[:, 0] = s[a, 0] + 6 * 0.01 * np.arange(1, t_script + 1)
        t[:, 1] = s[a, 1]
        t[:, 3] = 6.0
        tracks[a] = t
    sc = TE.ScriptedTraj.create(st.n, tracks, dtype=torch.float32,
                                device=cuda_device)
    eng = TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                           rep_force="twod", scripted=sc,
                           neighbors=TE.NeighborConfig(
                               cutoff=50.0, block=128, block_src=64, kb=24,
                               rebuild_every=20, screen=False))
    want = eng.simulate(st, n_steps, record=False, graph=False)[0]
    got = eng.simulate(st, n_steps, record=False, graph=True)[0]
    torch.cuda.synchronize()
    runner, = eng._runners.values()
    assert runner.graph is not None and runner.presorted
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    fin = got.s.cpu().numpy()
    for a, t in tracks.items():
        np.testing.assert_array_equal(fin[a, :4],
                                      t[-1, :4].astype(np.float32))
