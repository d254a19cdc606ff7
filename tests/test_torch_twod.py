"""PyTorch port: the twod model (bicycle2d kinematics with the spline
destination force, the twod field and the arrived-freeze) held to the
JAX package at float64 and to the reference's goldens, its culled path,
its population builder, and its graphed chunk.

On the CPU: the two golden scenarios of tests/test_parity_twod.py through
a port twin of `parity_common.run_scenario`, against JAX's run (1e-9 m)
and against the goldens at that test's tolerances; the culled twod path
(the kernels' plain version) against JAX's culled engine; the chunk's
static-buffer logic through `DirectRunner` (tests/test_torch_graph.py)
against the eager loop. On the card (`cuda` marker): the graphed chunk
against the eager loop, bit for bit, and a chunk with every host
synchronisation an error. The JAX package comes in through the `jx`
fixture, so the card's tests also run where JAX is not installed.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, InvPendulumBicycleParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402
from cyclistsocialforce_tpu_torch.state import (  # noqa: E402
    make_state, set_destinations)
from test_torch_graph import (MODES, DirectRunner, assert_same,  # noqa: E402
                              simulate_direct, snapshot)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
K, STEPS = 5, 12          # two chunks and a 2-step tail
HIST = 128                # the spline force's 1 s lookback needs 101

# the golden scenarios of tests/test_parity_twod.py: (file, initial
# states, destinations, steps (None: the golden's), desired speeds,
# assert_parity's tolerances)
ENCROACH_S0 = np.array([[-6.0, 0, 0, 5, 0, 0, 0, 0],
                        [15.0, -20, np.pi / 2, 5, 0, 0, 0, 0],
                        [13.0, -20, np.pi / 2, 5, 0, 0, 0, 0]])
ENCROACH_DESTS = [((35, 64, 65), (0, 0, 0)), ((15, 15, 15), (20, 49, 50)),
                  ((13, 13, 13), (20, 49, 50))]
PARCOURS_DESTS = ((10, 20, 30, 40, 50, 50, 50), (0, 4, -4, 0, 4, 30, 31))
SCENARIOS = {
    "encroachment": ("encroachment_twod.npz", ENCROACH_S0, ENCROACH_DESTS,
                     700, [4.5, 5.0, 5.0],
                     dict(pos_tol=1e-6, force_tol=1e-6, v_tol=1e-6)),
    "parcours": ("parcours_twod.npz", np.array([[0.0, 0, 0, 5, 0]]),
                 [PARCOURS_DESTS], None, None, {}),
}


@pytest.fixture
def jx():
    """The JAX package's modules and test helpers used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import parity_common

    from cyclistsocialforce_tpu import engine, make_state, params
    from cyclistsocialforce_tpu.models import MODELS as JMODELS

    return types.SimpleNamespace(jax=jax, jnp=jnp, JE=engine, JP=params,
                                 make_state=make_state, MODELS=JMODELS,
                                 pc=parity_common)


def run_scenario_port(model_name, params, s0, dests, n_steps,
                      v_desired=None):
    """The port's twin of `parity_common.run_scenario`: (traj [T, N, 8],
    fx [T, N], fy [T, N]) as numpy arrays."""
    s0 = np.asarray(s0, dtype=np.float64)
    n = s0.shape[0]
    st = make_state(s0, dtype=torch.float64, device=DEV)
    for a, (dx, dy) in enumerate(dests):
        st = set_destinations(st, a, dx, dy)
    p = as_population(params, n, device=DEV)
    if v_desired is not None:
        p = p.replace(v_desired_default=torch.tensor(v_desired,
                                                     dtype=torch.float64))
    model = MODELS[model_name]
    st = prepare(model, p, st)
    _, (traj, fx, fy) = TE.Engine.create(p, model).simulate(
        st, n_steps, record_forces=True)
    return traj.numpy(), fx.numpy(), fy.numpy()


@functools.lru_cache(maxsize=None)
def port_run(name, n_steps):
    _, s0, dests, _, v_desired, _ = SCENARIOS[name]
    return run_scenario_port("twod", InvPendulumBicycleParams.create(), s0,
                             dests, n_steps, v_desired)


def golden_steps(jx, name):
    golden = jx.pc.load_golden(SCENARIOS[name][0])
    steps = SCENARIOS[name][3] or golden["traj_0"].shape[1] - 1
    return golden, steps


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_twod_trajectories_match_jax(jx, name):
    """The golden scenarios through the port and through the JAX package
    at float64: every state, force and step within 1e-9."""
    _, s0, dests, _, v_desired, _ = SCENARIOS[name]
    _, steps = golden_steps(jx, name)
    want = jx.pc.run_scenario("twod", jx.JP.InvPendulumBicycleParams.create(),
                              s0, dests, steps, v_desired=v_desired)
    got = port_run(name, steps)
    pos = np.hypot(got[0][..., 0] - want[0][..., 0],
                   got[0][..., 1] - want[0][..., 1])
    assert pos.max() < 1e-9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_twod_goldens(jx, name):
    """The reference's goldens at tests/test_parity_twod.py's tolerances
    (encroachment 1e-6 on position, force and speed; parcours
    `assert_parity`'s defaults)."""
    golden, steps = golden_steps(jx, name)
    traj, fx, fy = port_run(name, steps)
    jx.pc.assert_parity(golden, traj, fx, fy, traj.shape[1],
                        **SCENARIOS[name][5])


def test_build_population_draws_as_jax(jx):
    """`build_population(model="twod")` draws the JAX package's
    `__graft_entry__._build(model_name="twod")` crowd, sized for twod."""
    from __graft_entry__ import _build

    _, want = _build(300, np.float64, density=0.02, hist_len=HIST,
                     pad_to_block=128, model_name="twod")
    got = build_population(300, 0.02, HIST, 128, torch.float64, DEV,
                           model="twod")
    for f in ("s", "dest", "destqueue", "nq", "active", "uid", "pos_hist",
              "dyn_x", "dyn_gains", "zrid", "znav"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.dyn_x.shape[1] == 0 and got.hist_len == HIST


def twod_engine(backend="pallas", rebuild_every=K, params=None, **kw):
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=rebuild_every, screen=False, backend=backend)
    return TE.Engine.create(params or BicycleParams.create(), MODELS["twod"],
                            neighbors=TE.NeighborConfig(**{**cfg, **kw}))


def crowd(n, device=DEV, dtype=torch.float32):
    return build_population(n, 0.02, HIST, 128, dtype, device, model="twod")


def test_twod_culled_matches_jax(jx):
    """The slice's path at a small size: 512 riders, the culled twod
    stage through K1's plain version in float64, 12 steps with rebuilds
    every 5, against JAX's culled engine (its XLA pair path)."""
    st = crowd(512, dtype=torch.float64)
    jst = jx.make_state(st.s[:, :5].numpy(), hist_len=HIST,
                        dtype=np.float64, model=jx.MODELS["twod"])
    jst = jst.replace(dest=jx.jnp.asarray(st.dest.numpy()),
                      destqueue=jx.jnp.asarray(st.destqueue.numpy()))
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=K, screen=False)
    jeng = jx.JE.Engine.create(jx.JP.BicycleParams.create(),
                               jx.MODELS["twod"],
                               neighbors=jx.JE.NeighborConfig(
                                   backend="xla", **cfg))
    want, _ = jx.jax.jit(lambda e, s: e.simulate(s, STEPS, record=False))(
        jeng, jst)
    got, _ = twod_engine().simulate(st, STEPS, record=False)
    for f in ("s", "dest", "destpointer", "znav", "pos_hist", "i"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("mode", ["none", "metrics_sorted", "states"])
def test_twod_direct_runner_equals_eager_loop(mode):
    """The twod chunk behind the runner's static buffers (the chunk run
    in place of a replay) equals the eager loop in every field and
    record; the runner is the engine's, its lookback kept."""
    eng = twod_engine()
    st = crowd(512)
    want = eng.simulate(st, STEPS, graph=False, **MODES[mode])
    got = simulate_direct(eng, st, STEPS, mode)
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert isinstance(runner, DirectRunner) and runner.replays == STEPS // K
    assert eng.dest_kw == {"lookback": 100}
    assert torch.isfinite(got[0].s).all()


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


CARD_STEPS, CARD_K = 45, 20        # two chunks and a 5-step tail


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "metrics_sorted", "states"])
def test_cuda_twod_graph_equals_eager(cuda_device, mode):
    """The graphed twod run equals the eager loop bit for bit; the
    capture records one K1 launch per step."""
    eng = twod_engine(rebuild_every=CARD_K)
    st = crowd(4096, cuda_device)
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
def test_cuda_twod_chunk_has_no_sync_point(cuda_device):
    """One eager twod chunk on the card with every host synchronisation
    an error: the spline force's fallback pass and ring reads included."""
    eng = twod_engine(rebuild_every=CARD_K)
    st = crowd(4096, cuda_device)
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
