"""PyTorch port: the planar point bicycle (`models.planarpoint`) and the
planar two-wheeler (`models.planarbicycle`), their parameters with complex
poles, and a `MixedEngine` of invpendulum and planarpoint riders, held to
the JAX package at float64 and to the reference's goldens.

On the CPU: one step of each model against the JAX step; the goldens of
tests/test_parity_planarpoint.py and tests/test_parity_planarbicycle.py
through the port's twin of `parity_common.run_scenario`, against JAX's
run (1e-9 m) and against the goldens at those tests' tolerances; the
poles kept complex through `create`, `as_population` and
`convert.params_from_jax`; per-rider poles; a `MixedEngine` of
invpendulum and planarpoint groups against JAX's; the chunk's
static-buffer logic through `DirectRunner`. On the card (`cuda` marker):
the graphed runs against the eager loop, bit for bit, and a chunk of each
with every host synchronisation an error.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.mixed import (MixedEngine,  # noqa: E402
                                                prepare_groups)
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    PlanarBicycleParams, PlanarPointBicycleParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402
from test_torch_graph import (MODES, DirectRunner, assert_same,  # noqa: E402
                              simulate_direct, snapshot)
from test_torch_twod import (ENCROACH_DESTS, ENCROACH_S0,  # noqa: E402
                             PARCOURS_DESTS, run_scenario_port)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = 1e-12
K, STEPS = 5, 12          # two chunks and a 2-step tail
HIST = 128                # the spline force's 1 s lookback needs 101
PARAMS = {"planarpoint": PlanarPointBicycleParams,
          "planarbicycle": PlanarBicycleParams}
PAIR = (-1.0141284591434665 + 1.226826644413086j,
        -1.0141284591434665 - 1.226826644413086j)


@pytest.fixture
def jx():
    """The JAX package's modules and test helpers used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import parity_common

    from cyclistsocialforce_tpu import make_state, params
    from cyclistsocialforce_tpu import mixed as JM
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import prepare as jprepare
    from cyclistsocialforce_tpu.state import set_destinations

    return types.SimpleNamespace(jax=jax, jnp=jnp, JP=params, JM=JM,
                                 make_state=make_state, MODELS=JMODELS,
                                 prepare=jprepare, pc=parity_common,
                                 set_destinations=set_destinations)


def jparams(jx, model, **kw):
    return getattr(jx.JP, PARAMS[model].__name__).create(**kw)


# ---- one step ----------------------------------------------------------------


def random_state(jx, model, n=12, seed=4):
    """A JAX float64 state of `model` with random positions, headings,
    speeds (0.5 to 7 m/s), steer, latents and forces."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 8))
    s0[:, :2] = rng.uniform(-20, 20, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = np.linspace(0.5, 7.0, n)
    s0[:, 4] = rng.uniform(-0.3, 0.3, n)
    st = jx.make_state(s0, dtype=np.float64, hist_len=8,
                       model=jx.MODELS[model])
    st = jx.prepare(jx.MODELS[model], jparams(jx, model), st)
    st = st.replace(dyn_x=st.dyn_x + jx.jnp.asarray(
        rng.normal(0, 0.05, tuple(st.dyn_x.shape))),
        dyn_v=st.dyn_v + jx.jnp.asarray(rng.normal(0, 0.3, n)))
    return st, rng.normal(0, 4, n), rng.normal(0, 4, n)


@pytest.mark.parametrize("model", sorted(PARAMS))
@pytest.mark.parametrize("per_rider", [False, True])
def test_one_step_matches_jax(jx, model, per_rider):
    """One `step` of every rider, shared or per-rider parameters, against
    the JAX step at 1e-12 (absolute and relative)."""
    st, fx, fy = random_state(jx, model)
    jp, tp = jparams(jx, model), PARAMS[model].create()
    if per_rider:
        jp, tp = jx.JP.as_population(jp, st.n), as_population(tp, st.n, DEV)
    want = jx.jax.jit(jx.MODELS[model].step)(jp, st, jx.jnp.asarray(fx),
                                             jx.jnp.asarray(fy))
    got = MODELS[model].step(tp, convert.state_from_jax(st, DEV),
                             torch.from_numpy(fx), torch.from_numpy(fy))
    for f in ("s", "dyn_x", "dyn_v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    for f in ("dyn_x", "dyn_v"):
        np.testing.assert_array_equal(
            getattr(prepare(MODELS[model], tp,
                            convert.state_from_jax(st, DEV)), f).numpy(),
            np.asarray(getattr(jx.prepare(jx.MODELS[model], jp, st), f)))


def test_planarbicycle_at_standstill_stays_finite(jx):
    """At v = 0 the pair (A, B) is not controllable (the reference
    asserts): the placement speed is held at 1e-9, so a rider at rest
    and one at 1e-10 m/s take the same steer/yaw sample, and it is
    finite. (The JAX step gives NaN there: `jax.scipy.linalg.expm` of the
    FOH matrix, whose norm is ~2.5e5 at that speed, ROADMAP Queue 3.)"""
    st, fx, fy = random_state(jx, "planarbicycle", n=4)
    tst = convert.state_from_jax(st, DEV)
    s = tst.s.clone()
    s[:2, 3] = torch.tensor([0.0, 1e-10], dtype=torch.float64)
    tst = tst.replace(s=s, dyn_x=tst.dyn_x[[0, 0, 2, 3]])
    fx[1], fy[1] = fx[0], fy[0]
    got = MODELS["planarbicycle"].step(
        PlanarBicycleParams.create(), tst, torch.from_numpy(fx),
        torch.from_numpy(fy))
    assert torch.isfinite(got.s).all() and torch.isfinite(got.dyn_x).all()
    assert torch.equal(got.dyn_x[0], got.dyn_x[1])


# ---- goldens -----------------------------------------------------------------


# name: (model, golden, initial states, destinations, desired speeds,
# the JAX test's assert_parity tolerances)
SCENARIOS = {
    "encroachment_planarpoint": (
        "planarpoint", "encroachment_planarpoint.npz", ENCROACH_S0[:, :4],
        ENCROACH_DESTS, [4.5, 5.0, 5.0], {}),
    "parcours_planarpoint": (
        "planarpoint", "parcours_planarpoint.npz", np.array([[0.0, 0, 0,
                                                             5]]),
        [PARCOURS_DESTS], None, {}),
    "encroachment_planarbicycle": (
        "planarbicycle", "encroachment_planarbicycle.npz", ENCROACH_S0,
        ENCROACH_DESTS, [4.5, 5.0, 5.0],
        dict(pos_tol=1e-9, force_tol=1e-9, v_tol=1e-9)),
}


@functools.lru_cache(maxsize=None)
def port_run(name, n_steps):
    model, _, s0, dests, v_desired, _ = SCENARIOS[name]
    return run_scenario_port(model, PARAMS[model].create(), s0, dests,
                             n_steps, v_desired)


def golden_steps(jx, name):
    golden = jx.pc.load_golden(SCENARIOS[name][1])
    return golden, golden["traj_0"].shape[1] - 1


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_planar_trajectories_match_jax(jx, name):
    """The golden scenarios through the port and through the JAX package
    at float64: every position within 1e-9 m, every state and force
    within 1e-9."""
    model, _, s0, dests, v_desired, _ = SCENARIOS[name]
    _, steps = golden_steps(jx, name)
    want = jx.pc.run_scenario(model, jparams(jx, model), s0, dests, steps,
                              v_desired=v_desired)
    got = port_run(name, steps)
    pos = np.hypot(got[0][..., 0] - want[0][..., 0],
                   got[0][..., 1] - want[0][..., 1])
    assert pos.max() < 1e-9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_planar_goldens(jx, name):
    """The reference's goldens at the JAX tests' tolerances (planarpoint
    `assert_parity`'s defaults, planarbicycle 1e-9)."""
    golden, steps = golden_steps(jx, name)
    traj, fx, fy = port_run(name, steps)
    jx.pc.assert_parity(golden, traj, fx, fy, traj.shape[1],
                        **SCENARIOS[name][5])


# ---- parameters ----------------------------------------------------------------


def test_poles_stay_complex(jx):
    """The poles keep their imaginary parts: a shared set is a tuple of
    complex numbers after `create` (the defaults and a given pair), an
    [N, k] complex128 tensor after `as_population`, and
    `convert.params_from_jax` carries JAX's shared tuple and per-rider
    arrays across as the same."""
    pb = PlanarBicycleParams.create()
    assert pb.poles == PAIR
    given = PlanarBicycleParams.create(poles=np.array([-2 + 1j, -2 - 1j]))
    assert given.poles == (-2 + 1j, -2 - 1j)
    pp = PlanarPointBicycleParams.create()
    assert pp.poles == (-2 + 0j,) and pp.gains == (2.0,)
    pop = as_population(pb, 4, DEV)
    assert pop.poles.dtype == torch.complex128
    assert tuple(pop.poles.shape) == (4, 2)
    np.testing.assert_array_equal(pop.poles.numpy(), np.tile(PAIR, (4, 1)))
    assert as_population(pp, 3, DEV).gains.shape == (3, 1)
    for model in PARAMS:
        jp = jparams(jx, model)
        shared = convert.params_from_jax(jp, DEV)
        assert shared.poles == PARAMS[model].create().poles
        per = convert.params_from_jax(jx.JP.as_population(jp, 5), DEV)
        assert per.poles.dtype == torch.complex128
        np.testing.assert_array_equal(
            per.poles.numpy(), as_population(PARAMS[model].create(), 5,
                                             DEV).poles.numpy())


def test_per_rider_poles_planarbicycle_match_jax(jx):
    """Riders with poles of their own: the port's step against JAX's
    (which reads the per-rider pole arrays), and each rider's row against
    the port's step with that rider's pole pair shared."""
    st, fx, fy = random_state(jx, "planarbicycle", n=6, seed=9)
    re = -np.linspace(0.6, 3.0, 6)
    im = np.linspace(0.0, 2.0, 6)
    poles = np.stack([re + 1j * im, re - 1j * im], axis=1)
    jp = jx.JP.as_population(jparams(jx, "planarbicycle"), 6)
    jp = jp.replace(poles=(jx.jnp.asarray(poles[:, 0]),
                           jx.jnp.asarray(poles[:, 1])))
    want = jx.jax.jit(jx.MODELS["planarbicycle"].step)(
        jp, st, jx.jnp.asarray(fx), jx.jnp.asarray(fy))
    tp = as_population(PlanarBicycleParams.create(), 6, DEV).replace(
        poles=torch.from_numpy(poles))
    tst = convert.state_from_jax(st, DEV)
    args = (torch.from_numpy(fx), torch.from_numpy(fy))
    got = MODELS["planarbicycle"].step(tp, tst, *args)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=TOL,
                               atol=TOL)
    for i in range(6):
        one = MODELS["planarbicycle"].step(
            PlanarBicycleParams.create(poles=poles[i]), tst, *args)
        np.testing.assert_array_equal(one.s[i].numpy(), got.s[i].numpy())


def test_per_rider_poles_planarpoint():
    """Each rider's yaw gain is its own pole's: a row of the per-rider
    step equals the step with that rider's pole shared. (The JAX function
    takes the first rider's pole for all, ROADMAP Queue 3.)"""
    st = prepare(MODELS["planarpoint"], PlanarPointBicycleParams.create(),
                 build_population(8, 0.02, 8, None, torch.float64, DEV,
                                  model="planarpoint"))
    fx, fy = torch.linspace(-3, 3, 8, dtype=torch.float64), torch.ones(
        8, dtype=torch.float64)
    poles = -torch.linspace(0.5, 4.0, 8, dtype=torch.float64)
    tp = as_population(PlanarPointBicycleParams.create(), 8, DEV).replace(
        poles=poles.to(torch.complex128)[:, None])
    got = MODELS["planarpoint"].step(tp, st, fx, fy)
    for i in range(8):
        one = MODELS["planarpoint"].step(PlanarPointBicycleParams.create(
            poles=(complex(poles[i]),)), st, fx, fy)
        np.testing.assert_array_equal(one.s[i].numpy(), got.s[i].numpy())
    assert got.s[:, 2].unique().numel() == 8


# ---- MixedEngine ---------------------------------------------------------------


def test_mixed_invpendulum_planarpoint_matches_jax(jx):
    """A `MixedEngine` of 6 invpendulum riders (the poly propagator) and 6
    planarpoint riders, close enough to interact, 150 steps on the dense
    stage: the port against JAX's `MixedEngine`, every position within
    1e-9 m and every state within 1e-8 (the invpendulum riders' steer
    loop turns 1e-10 m into 4e-9 rad in this tight crowd), and the two
    groups repel each other."""
    rng = np.random.default_rng(12)
    n = 12
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, 25, n)
    s0[:, 1] = rng.uniform(0, 25, n)
    s0[:, 2] = rng.uniform(-0.4, 0.4, n)
    s0[:, 3] = rng.uniform(3.5, 5.5, n)
    dests = [((float(x) + 40.0,), (float(y),)) for x, y in s0[:, :2]]
    jst = jx.make_state(s0, dtype=np.float64, hist_len=HIST)
    for a, (dx, dy) in enumerate(dests):
        jst = jx.set_destinations(jst, a, dx, dy)
    groups = [("invpendulum", jx.JP.as_population(
                   jx.JP.InvPendulumBicycleParams.create(zoh_poly=32), 6), 6),
              ("planarpoint", jx.JP.as_population(
                   jx.JP.PlanarPointBicycleParams.create(), 6), 6)]
    jeng = jx.JM.MixedEngine.create(groups)
    jst = jx.JM.prepare_groups(jeng, jst)
    _, want = jx.jax.jit(lambda s: jeng.simulate(s, 150))(jst)

    specs = convert.group_specs_from_jax(jeng, DEV)
    assert [m for m, _, _ in specs] == [MODELS["invpendulum"],
                                        MODELS["planarpoint"]]
    eng = MixedEngine.create(specs)
    st = prepare_groups(eng, convert.state_from_jax(
        jx.make_state(s0, dtype=np.float64, hist_len=HIST).replace(
            destqueue=jst.destqueue, dest=jst.dest, nq=jst.nq), DEV))
    _, traj = eng.simulate(st, 150)
    want = np.asarray(want)
    pos = np.hypot(*(traj.numpy() - want)[..., :2].transpose(2, 0, 1))
    assert pos.max() < 1e-9
    np.testing.assert_allclose(traj.numpy(), want, rtol=0, atol=1e-8)
    assert torch.isfinite(traj).all()

    alone = MixedEngine.create(specs[1:])
    sub = prepare_groups(alone, convert.state_from_jax(
        jx.make_state(s0[6:], dtype=np.float64, hist_len=HIST).replace(
            destqueue=jst.destqueue[6:], dest=jst.dest[6:], nq=jst.nq[6:]),
        DEV))
    _, solo = alone.simulate(sub, 150)
    assert (traj[:, 6:, :2] - solo[..., :2]).abs().max() > 1e-3


# ---- the chunk -----------------------------------------------------------------


def planar_engine(model, rebuild_every=K, **kw):
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=rebuild_every, screen=False, backend="pallas")
    return TE.Engine.create(PARAMS[model].create(), MODELS[model],
                            neighbors=TE.NeighborConfig(**{**cfg, **kw}))


def crowd(model, n, device=DEV, dtype=torch.float32):
    st = build_population(n, 0.02, HIST, 128, dtype, device, model=model)
    return prepare(MODELS[model], PARAMS[model].create(), st)


@pytest.mark.parametrize("model", sorted(PARAMS))
@pytest.mark.parametrize("mode", ["none", "states"])
def test_planar_direct_runner_equals_eager_loop(model, mode):
    """The chunk behind the runner's static buffers (the chunk run in
    place of a replay) equals the eager loop in every field and record."""
    eng = planar_engine(model)
    st = crowd(model, 256)
    want = eng.simulate(st, STEPS, graph=False, **MODES[mode])
    got = simulate_direct(eng, st, STEPS, mode)
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert isinstance(runner, DirectRunner) and runner.replays == STEPS // K
    assert torch.isfinite(got[0].s).all()


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


CARD_STEPS, CARD_K = 45, 20        # two chunks and a 5-step tail


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(PARAMS))
@pytest.mark.parametrize("mode", ["none", "metrics_sorted", "states"])
def test_cuda_planar_graph_equals_eager(cuda_device, model, mode):
    """The graphed run equals the eager loop bit for bit; the capture
    records one K1 launch per step."""
    eng = planar_engine(model, rebuild_every=CARD_K)
    st = crowd(model, 4096, cuda_device)
    assert not eng.neighbor_cache(st)[3].any()
    want = eng.simulate(st, CARD_STEPS, graph=False, **MODES[mode])
    PF.reset_launches()
    got = eng.simulate(st, CARD_STEPS, graph=True, **MODES[mode])
    torch.cuda.synchronize()
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert runner.captured == (CARD_K, 0, 0)
    assert torch.isfinite(got[0].s).all()


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(PARAMS))
def test_cuda_planar_chunk_has_no_sync_point(cuda_device, model):
    """One eager chunk on the card with every host synchronisation an
    error: the pole placement, the 2x2 solve and the matrix power
    included."""
    eng = planar_engine(model, rebuild_every=CARD_K)
    st = crowd(model, 4096, cuda_device)
    cache = eng.neighbor_cache(st)
    st = TE.permute_state(st, cache[0])
    rows = TE.record_buffers("metrics", CARD_K, st)
    eng.run_chunk(st, cache, 1, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run_chunk(st, cache, CARD_K, True, "metrics", rows,
                      cache[3].sum())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(rows[0]).all()
