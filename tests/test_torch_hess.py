"""PyTorch port: the Hess bike-rider model (`models.hessbikerider`,
`HessBikeRiderParams`) held to the JAX package at float64 and to
tests/test_hess.py's control-theory oracle (the reference's Hess runtime
cannot run upstream, so no golden exists).

On the CPU: the parameters and their conversion from JAX; `prepare` and
one step (shared and per-rider gains) against the JAX step at 1e-12; the
encroachment scenario at riding speed against JAX's run (1e-9 m); the
closed loop's stability at 5-7 m/s, its unity DC gain from the yaw
command to the yaw and a yaw step tracked by the midpoint rule (built
from the port's `hess_A_B`, checked with numpy); the culled path against
JAX's culled engine; the chunk behind the runner's static buffers. On the
card (`cuda` marker): the graphed run against the eager loop bit for bit,
and a chunk with every host synchronisation an error.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.models import \
    hessbikerider as HB  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    HessBikeRiderParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import \
    build_flagship_crowd  # noqa: E402
from test_torch_graph import (MODES, DirectRunner, assert_same,  # noqa: E402
                              simulate_direct, snapshot)
from test_torch_twod import (ENCROACH_DESTS, ENCROACH_S0,  # noqa: E402
                             run_scenario_port)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = 1e-12
K, STEPS = 5, 12          # two chunks and a 2-step tail


@pytest.fixture
def jx():
    """The JAX package's modules and test helpers used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import parity_common

    from cyclistsocialforce_tpu import engine, make_state, params
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import hessbikerider as JH
    from cyclistsocialforce_tpu.models import prepare as jprepare

    return types.SimpleNamespace(jax=jax, jnp=jnp, JE=engine, JP=params,
                                 JH=JH, make_state=make_state,
                                 MODELS=JMODELS, prepare=jprepare,
                                 pc=parity_common)


@functools.lru_cache(maxsize=None)
def params():
    return HessBikeRiderParams.create()


def assert_rel(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_params_match_jax(jx):
    """The gains, the matrices and the fixed (zero) feedback gains, and
    `convert.params_from_jax` of the JAX params; `MODELS` has the model
    under its own name and under the JAX package's ("hess")."""
    want = jx.JH.HessBikeRiderParams.create()
    got = params()
    for f in HB.GAIN_FIELDS + ("l", "m", "g"):
        assert getattr(got, f) == pytest.approx(float(getattr(want, f)),
                                                rel=1e-15)
    for f in ("br_A0", "br_A1", "br_A2", "br_B", "br_gains_fixed"):
        assert_rel(np.asarray(getattr(got, f)), getattr(want, f))
    assert got.br_pole_lin is None
    conv = convert.params_from_jax(jx.JP.as_population(want, 4), DEV)
    assert type(conv) is HessBikeRiderParams
    assert tuple(conv.k_delta.shape) == (4,)
    assert MODELS["hessbikerider"] is MODELS["hess"] is HB


def step_inputs(jx, n=16, seed=6):
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 8))
    s0[:, :2] = rng.uniform(-20, 20, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = np.linspace(0.5, 9.5, n)
    s0[:, 4:8] = rng.uniform(-0.2, 0.2, (n, 4))
    st = jx.make_state(s0, dtype=np.float64, hist_len=8,
                       model=jx.MODELS["hess"])
    st = jx.prepare(jx.MODELS["hess"], jx.JH.HessBikeRiderParams.create(),
                    st)
    dyn = np.asarray(st.dyn_x) + rng.normal(0, 0.05, (n, 7))
    st = st.replace(dyn_x=jx.jnp.asarray(dyn))
    return st, rng.normal(0, 4, n), rng.normal(0, 4, n)


@pytest.mark.parametrize("per_rider", [False, True])
def test_one_step_matches_jax(jx, per_rider):
    """`prepare` and one `step` against JAX's at 1e-12, with shared gains
    and with per-rider gains (each rider's own k_delta, scaled)."""
    st, fx, fy = step_inputs(jx)
    jp, tp = jx.JH.HessBikeRiderParams.create(), params()
    if per_rider:
        scale = np.linspace(0.9, 1.1, st.n)
        jp = jx.JP.as_population(jp, st.n)
        jp = jp.replace(k_delta=jp.k_delta * scale)
        tp = as_population(tp, st.n, DEV)
        tp = tp.replace(k_delta=tp.k_delta * torch.from_numpy(scale))
    tst = convert.state_from_jax(st, DEV)
    fresh = prepare(HB, tp, tst)
    want_p = jx.prepare(jx.MODELS["hess"], jp, st)
    assert_rel(fresh.dyn_x, want_p.dyn_x)
    want = jx.jax.jit(jx.MODELS["hess"].step)(
        jp, st, jx.jnp.asarray(fx), jx.jnp.asarray(fy))
    got = HB.step(tp, tst, torch.from_numpy(fx), torch.from_numpy(fy))
    for f in ("s", "dyn_x", "dyn_v"):
        assert_rel(getattr(got, f), getattr(want, f))


@functools.lru_cache(maxsize=None)
def riding_scenario(steps):
    s0 = np.asarray(ENCROACH_S0, dtype=float).copy()
    s0[:, 3] = 5.5
    return s0, run_scenario_port("hessbikerider", params(), s0,
                                 ENCROACH_DESTS, steps, [5.5, 5.5, 5.5])


def test_trajectory_matches_jax(jx):
    """tests/test_hess.py's scenario (the encroachment riders at 5.5 m/s)
    through the port and through the JAX package at float64, 300 steps:
    every position within 1e-9 m, every state and force within 1e-9."""
    s0, got = riding_scenario(300)
    want = jx.pc.run_scenario("hess", jx.JH.HessBikeRiderParams.create(),
                              s0, ENCROACH_DESTS, 300,
                              v_desired=[5.5, 5.5, 5.5])
    pos = np.hypot(got[0][..., 0] - want[0][..., 0],
                   got[0][..., 1] - want[0][..., 1])
    assert pos.max() < 1e-9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


def test_scenario_rides_upright():
    """tests/test_hess.py's end-to-end bar on the port: finite, roll under
    pi/3, rider 0's yaw within 0.5 rad on its straight run."""
    traj = riding_scenario(300)[1][0]
    assert np.isfinite(traj).all()
    assert np.abs(traj[:, :, 5]).max() < np.pi / 3
    assert np.abs(traj[:, 0, 2]).max() < 0.5


def test_control_theory_oracle():
    """tests/test_hess.py's oracle on the port's closed loop: A(v) stable
    at 5, 6 and 7 m/s; unity DC gain from the yaw command to the yaw at
    5.5 m/s; a 0.3 rad yaw step tracked within 1e-3 rad after 8 s of the
    midpoint rule (numpy, from the port's `hess_A_B`)."""
    v = torch.tensor([5.0, 6.0, 7.0, 5.5], dtype=torch.float64)
    A, B = HB.hess_A_B(params(), v)
    for a, vv in zip(A[:3].numpy(), (5.0, 6.0, 7.0)):
        ev = np.linalg.eigvals(a)
        assert np.all(ev.real < 0), f"unstable at v={vv}: {ev}"
    A, B = A[3].numpy(), B[3].numpy()
    x_ss = -np.linalg.solve(A, B)
    np.testing.assert_allclose(x_ss[4], 1.0, atol=1e-9)
    h, psi_c = 0.01, 0.3
    lhs = np.eye(7) - h / 2 * A
    rhs_m = np.eye(7) + h / 2 * A
    x = np.zeros(7)
    for _ in range(800):
        x = np.linalg.solve(lhs, rhs_m @ x + h * B * psi_c)
    assert abs(x[4] - psi_c) < 1e-3


def hess_engine(rebuild_every=K):
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=rebuild_every, screen=False, backend="pallas")
    return TE.Engine.create(params(), HB,
                            neighbors=TE.NeighborConfig(**cfg))


def crowd(n, device=DEV, dtype=torch.float32):
    st = build_flagship_crowd(n, 0.02, 8, 128, dtype, device,
                              model="hessbikerider")
    return prepare(HB, params(), st)


def test_culled_matches_jax(jx):
    """256 stable riders at 0.02 /m^2 through K1's plain version in
    float64, 12 steps with rebuilds every 5, against JAX's culled engine
    (its XLA pair path): every field within 1e-9."""
    st = crowd(256, dtype=torch.float64)
    jp = jx.JH.HessBikeRiderParams.create()
    jst = jx.make_state(st.s[:, :5].numpy(), hist_len=8, dtype=np.float64,
                        model=jx.MODELS["hess"])
    jst = jst.replace(dest=jx.jnp.asarray(st.dest.numpy()),
                      destqueue=jx.jnp.asarray(st.destqueue.numpy()))
    jst = jx.prepare(jx.MODELS["hess"], jp, jst)
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=K, screen=False)
    jeng = jx.JE.Engine.create(jp, jx.MODELS["hess"],
                               neighbors=jx.JE.NeighborConfig(
                                   backend="xla", **cfg))
    want, _ = jx.jax.jit(lambda e, s: e.simulate(s, STEPS, record=False))(
        jeng, jst)
    got, _ = hess_engine().simulate(st, STEPS, record=False)
    for f in ("s", "dyn_x", "dest", "znav"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("mode", ["none", "states"])
def test_direct_runner_equals_eager_loop(mode):
    eng = hess_engine()
    st = crowd(256)
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
@pytest.mark.parametrize("mode", ["none", "metrics_sorted", "states"])
def test_cuda_hess_graph_equals_eager(cuda_device, mode):
    eng = hess_engine(rebuild_every=CARD_K)
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
def test_cuda_hess_chunk_has_no_sync_point(cuda_device):
    """One eager chunk on the card with every host synchronisation an
    error: the pivoted 7x7 solve included."""
    eng = hess_engine(rebuild_every=CARD_K)
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
