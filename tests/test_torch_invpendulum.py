"""PyTorch port: the inverted-pendulum bicycle (`models.invpendulum`, the
ZOH propagator tables of `InvPendulumBicycleParams`) held to the JAX
package at float64 and to the reference's goldens.

On the CPU: the tables of `create(zoh_lut=64)` and `create(zoh_poly=32)`
against JAX's; one step of each propagator (exact, LUT, piecewise
polynomial) with riders riding, walking, switching and arrived, against
the JAX step; the goldens of tests/test_parity_invpendulum.py and
tests/test_parity_walk_kaths.py through the port's twin of
`parity_common.run_scenario`, against JAX's run (1e-9 m) and against the
goldens at those tests' tolerances; the yaw step response of
tests/test_invpendulum_stepresponse.py against scipy; `as_population`
and `convert.params_from_jax` with both tables; the culled path (K1's
plain version) against JAX's culled engine; the chunk's static-buffer
logic through `DirectRunner` (tests/test_torch_graph.py); the engine
keeping the poly's coefficient matrix while other fits come and go. On
the card (`cuda` marker): the graphed run against the eager loop, bit for
bit, a chunk with every host synchronisation an error, and a poly graph
replayed after 17 other fits' graphs. The JAX package comes
in through the `jx` fixture, so the card's tests also run where JAX is not
installed.
"""

import functools
import gc
import types
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.models import \
    invpendulum as IP  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    InvPendulumBicycleParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402
from test_torch_graph import (MODES, STATE_FIELDS,  # noqa: E402
                              DirectRunner, assert_same, simulate_direct,
                              snapshot)
from test_torch_twod import (ENCROACH_DESTS, ENCROACH_S0,  # noqa: E402
                             run_scenario_port)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = 1e-12
K, STEPS = 5, 12          # two chunks and a 2-step tail
HIST = 128                # the spline force's 1 s lookback needs 101
# the propagators: create() keywords
PROPAGATORS = {"exact": {}, "lut": {"zoh_lut": 64}, "poly": {"zoh_poly": 32}}


@pytest.fixture
def jx():
    """The JAX package's modules and test helpers used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import parity_common

    from cyclistsocialforce_tpu import engine, make_state, params
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import prepare as jprepare

    return types.SimpleNamespace(jax=jax, jnp=jnp, JE=engine, JP=params,
                                 make_state=make_state, MODELS=JMODELS,
                                 prepare=jprepare, pc=parity_common)


@functools.lru_cache(maxsize=None)
def port_params(propagator):
    return InvPendulumBicycleParams.create(**PROPAGATORS[propagator])


def rel_rows(got, want):
    """Per row of two tables: max |got - want| over max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)


# ---- the tables --------------------------------------------------------------


def test_zoh_tables_match_jax(jx):
    """`create(zoh_lut=64)`: every row within 1e-12 of JAX's, relative to
    the row, across the riding band (v >= 1.45 m/s, what the riding branch
    reads), and within 1e-10 below it (rows near v = 0, where the gain
    schedule diverges as 1/v^3 and the exponential takes 12 squarings);
    the grid the same. `create(zoh_poly=32)`: the coefficients within 1e-9
    of the largest, the band the same, and the fit within 1e-5 of the
    exact sweep over the riding band (tests/test_gains_lut.py's bar)."""
    from cyclistsocialforce_tpu.ops.piecewise import fit_error

    tab, v0, dv = port_params("lut").ip_zoh_lut
    jtab, jv0, jdv = jx.JP.InvPendulumBicycleParams.create(
        zoh_lut=64).ip_zoh_lut
    assert tab.dtype == torch.float64 and tuple(tab.shape) == (64, 30)
    assert (v0, dv) == (float(jv0), float(jdv))
    vs = v0 + dv * np.arange(64)
    rel = rel_rows(tab.numpy(), jtab)
    assert rel[vs >= 1.45].max() <= TOL and rel.max() <= 1e-10
    assert np.isfinite(tab.numpy()).all()

    C, lo, seg = port_params("poly").ip_zoh_poly
    jC, jlo, jseg = jx.JP.InvPendulumBicycleParams.create(
        zoh_poly=32).ip_zoh_poly
    assert (lo, seg) == (jlo, jseg) and len(C) == 32 and len(C[0]) == 180
    assert lo == InvPendulumBicycleParams.IP_ZOH_POLY_V_LO
    C, jC = np.asarray(C), np.asarray(jC)
    assert np.abs(C - jC).max() <= 1e-9 * np.abs(jC).max()
    sweep = InvPendulumBicycleParams._zoh_sweep(port_params("poly"))
    assert fit_error(port_params("poly").ip_zoh_poly, sweep,
                     band=(1.45, 7.0)) < 1e-5
    assert all(isinstance(c, float) for c in port_params("poly")
               .ip_zoh_poly[0][0])


# ---- one step of each propagator ---------------------------------------------


def fsm_states(jx, n=16, seed=8):
    """A JAX float64 invpendulum state in which the riders ride, walk,
    switch between the two and have arrived: speeds across the walking
    boundary, steer inside and outside delta_max_walk, step counters and
    steer-window counts on both sides of the 1 s window, random dynamics
    latents; and forces (fx, fy)."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 8))
    s0[:, :2] = rng.uniform(-20, 20, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = np.linspace(0.4, 6.5, n)
    s0[:, 4] = rng.uniform(-0.3, 0.3, n)
    s0[:, 5] = rng.uniform(-0.05, 0.05, n)
    st = jx.make_state(s0, dtype=np.float64, hist_len=8,
                       model=jx.MODELS["invpendulum"])
    st = jx.prepare(jx.MODELS["invpendulum"],
                    jx.JP.InvPendulumBicycleParams.create(), st)
    walking = rng.uniform(size=n) < 0.4
    znav = np.zeros((n, 3), dtype=bool)
    znav[:, 0] = True
    znav[[2, 9, 13]] = (False, False, True)
    st = st.replace(
        dyn_x=jx.jnp.asarray(np.concatenate(
            [np.asarray(st.dyn_x)[:, :5]
             + rng.normal(0, 0.02, (n, 5))], axis=1)),
        zrid=jx.jnp.asarray(np.stack([~walking, walking], axis=1)),
        walk_ok_steps=jx.jnp.asarray(rng.integers(0, 140, n),
                                     dtype=np.int32),
        i=jx.jnp.asarray(rng.integers(0, 200, n), dtype=np.int32),
        znav=jx.jnp.asarray(znav),
        pid_e=jx.jnp.asarray(rng.normal(0, 0.1, (n, 2))),
        pid_i=jx.jnp.asarray(rng.normal(0, 0.1, (n, 2))))
    fx, fy = rng.normal(0, 4, n), rng.normal(0, 4, n)
    return st, fx, fy


@pytest.mark.parametrize("propagator,per_rider", [
    ("exact", False), ("exact", True), ("lut", False), ("poly", False),
    ("poly", True)])
def test_one_step_matches_jax(jx, propagator, per_rider):
    """One `step` of every rider through each propagator, shared or
    per-rider parameters, against the JAX step at 1e-12 (absolute and
    relative: the random latents drive steer rates to ~300 rad/s): the
    riding, walking and arrived branches, the FSM and its counter."""
    st, fx, fy = fsm_states(jx)
    jp = jx.JP.InvPendulumBicycleParams.create(**PROPAGATORS[propagator])
    tp = port_params(propagator)
    if per_rider:
        jp = jx.JP.as_population(jp, st.n)
        tp = as_population(tp, st.n, DEV)
    want = jx.jax.jit(jx.MODELS["invpendulum"].step)(
        jp, st, jx.jnp.asarray(fx), jx.jnp.asarray(fy))
    got = IP.step(tp, convert.state_from_jax(st, DEV),
                  torch.from_numpy(fx), torch.from_numpy(fy))
    riding = np.asarray(want.zrid)[:, 0]
    assert riding.any() and (~riding).any()
    for f in ("s", "dyn_x", "pid_e", "pid_i", "zrid", "walk_ok_steps"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)


def test_prepare_matches_jax(jx):
    st, _, _ = fsm_states(jx)
    p = jx.JP.InvPendulumBicycleParams.create()
    want = jx.prepare(jx.MODELS["invpendulum"], p, st)
    got = prepare(MODELS["invpendulum"], port_params("exact"),
                  convert.state_from_jax(st, DEV))
    for f in ("dyn_x", "zrid", "walk_ok_steps"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


# ---- goldens -----------------------------------------------------------------


# (golden, initial states, destinations, desired speeds)
SCENARIOS = {
    "encroachment": ("encroachment_invpendulum.npz", ENCROACH_S0[:, :6],
                     ENCROACH_DESTS, [4.5, 5.0, 5.0]),
    "walk": ("walk_invpendulum.npz", np.array([[0.0, 0, 0, 0.5, 0, 0, 0,
                                                0]]),
             [((30, 31), (0, 0))], None),
}


@functools.lru_cache(maxsize=None)
def port_run(name, n_steps):
    _, s0, dests, v_desired = SCENARIOS[name]
    return run_scenario_port("invpendulum", port_params("exact"), s0,
                             dests, n_steps, v_desired)


def golden_steps(jx, name):
    golden = jx.pc.load_golden(SCENARIOS[name][0])
    return golden, golden["traj_0"].shape[1] - 1


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_invpendulum_trajectories_match_jax(jx, name):
    """Both golden scenarios through the port and through the JAX package
    at float64: every position within 1e-9 m at every step, every other
    state and force within 1e-8 (the walk's last steps: the spline force
    1 m before the last destination turns 1e-11 m into 4e-9 N of force
    and 1e-9 rad of steer)."""
    _, s0, dests, v_desired = SCENARIOS[name]
    _, steps = golden_steps(jx, name)
    want = jx.pc.run_scenario("invpendulum",
                              jx.JP.InvPendulumBicycleParams.create(), s0,
                              dests, steps, v_desired=v_desired)
    got = port_run(name, steps)
    pos = np.hypot(got[0][..., 0] - want[0][..., 0],
                   got[0][..., 1] - want[0][..., 1])
    assert pos.max() < 1e-9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)


def test_encroachment_invpendulum_golden(jx):
    """tests/test_parity_invpendulum.py's bar: `assert_parity`'s
    defaults."""
    golden, steps = golden_steps(jx, "encroachment")
    jx.pc.assert_parity(golden, *port_run("encroachment", steps), 3)


def test_walk_invpendulum_golden(jx):
    """tests/test_parity_walk_kaths.py's bar: 1e-6 m, 1e-8 m/s, and the
    rider starts walking and ends riding."""
    golden, steps = golden_steps(jx, "walk")
    traj = port_run("walk", steps)[0]
    ref = golden["traj_0"]
    perr = np.max(np.hypot(traj[:, 0, 0] - ref[0, 1:steps + 1],
                           traj[:, 0, 1] - ref[1, 1:steps + 1]))
    assert perr < 1e-6, f"max position err {perr}"
    np.testing.assert_allclose(traj[:, 0, 3], ref[3, 1:steps + 1], atol=1e-8)
    assert ref[3, 0] < 1.5 and np.max(traj[:, 0, 3]) > 3.0


def test_yaw_step_response_against_scipy():
    """tests/test_invpendulum_stepresponse.py on the port: a 30 deg yaw
    step at 5 m/s through the exact propagator, 700 samples, against the
    closed loop built independently with numpy and integrated with
    scipy's expm (1e-9); the loop tracks the yaw and the lean returns."""
    from scipy.linalg import expm

    p = port_params("exact")
    v, t_s, psi_d = 5.0, 0.01, np.radians(30.0)
    K = v * v / (p.g * p.l)
    K_tau_2 = v * p.l_2 / (p.g * p.l)
    A = np.zeros((5, 5))
    A[0, 1], A[1, 1], A[2, 3] = 1.0, -p.c_steer / p.i_steer_vertvert, 1.0
    A[3, 0] = -K / p.tau_1_squared
    A[3, 1] = -K_tau_2 / p.tau_1_squared
    A[3, 2] = 1.0 / p.tau_1_squared
    A[4, 0] = v / p.l
    B = np.zeros(5)
    B[1] = 1.0 / p.i_steer_vertvert
    K_x, K_u = (np.asarray(k, dtype=float)
                for k in p.fullstate_feedback_gains(v))
    aug = np.zeros((6, 6))
    aug[:5, :5] = (A - np.outer(B, K_x)) * t_s
    aug[:5, 5] = K_u * B * t_s
    e = expm(aug)
    x_ref, x = np.zeros(5), torch.zeros((1, 5), dtype=torch.float64)
    vv = torch.tensor([v], dtype=torch.float64)
    pd = torch.tensor([psi_d], dtype=torch.float64)
    for _ in range(700):
        x_ref = e[:5, :5] @ x_ref + e[:5, 5] * psi_d
        x = IP._riding_exact(p, vv, x, pd, t_s)
        np.testing.assert_allclose(x[0].numpy(), x_ref, atol=1e-9)
    assert abs(float(x[0, 4]) - psi_d) < 0.02 and abs(float(x[0, 2])) < 0.01


# ---- parameters ----------------------------------------------------------------


def test_as_population_keeps_the_tables_shared():
    """`as_population` broadcasts the numeric fields, keeps the LUT one
    shared table (placed on the device), the poly the same static tuple,
    and an absent table None (not a NaN tensor)."""
    lut = as_population(port_params("lut"), 5, DEV)
    tab, v0, dv = lut.ip_zoh_lut
    assert torch.equal(tab, port_params("lut").ip_zoh_lut[0])
    assert (v0, dv) == port_params("lut").ip_zoh_lut[1:]
    assert tuple(tab.shape) == (64, 30) and lut.ip_zoh_poly is None
    assert lut.h.shape == (5,) and lut.a_max.shape == (5, 2)
    poly = as_population(port_params("poly"), 5, DEV)
    assert poly.ip_zoh_poly is port_params("poly").ip_zoh_poly
    assert poly.ip_zoh_lut is None
    exact = as_population(port_params("exact"), 5, DEV)
    assert exact.ip_zoh_lut is None and exact.ip_zoh_poly is None


def test_graph_refuses_a_table_on_another_device():
    """A capture copies nothing from the host: a LUT left on the CPU is
    refused for a state on the card, the poly (a tuple) never is."""
    card = torch.device("cuda")
    with pytest.raises(ValueError, match="ip_zoh_lut"):
        TE._check_params_on(port_params("lut"), card)
    TE._check_params_on(port_params("poly"), card)
    TE._check_params_on(port_params("lut"), torch.device("cpu"))


@pytest.mark.parametrize("propagator", ["lut", "poly"])
def test_params_from_jax_carries_the_tables(jx, propagator):
    """`convert.params_from_jax` of JAX params with a table, shared and
    per rider: the LUT as a float64 tensor with its grid, the poly as the
    same tuple; the step on the converted params equals the step on the
    port's own."""
    jp = jx.JP.InvPendulumBicycleParams.create(**PROPAGATORS[propagator])
    for src in (jp, jx.JP.as_population(jp, 3)):
        conv = convert.params_from_jax(src, DEV)
        assert type(conv) is InvPendulumBicycleParams
        if propagator == "lut":
            tab, v0, dv = conv.ip_zoh_lut
            np.testing.assert_array_equal(tab.numpy(),
                                          np.asarray(jp.ip_zoh_lut[0]))
            assert (v0, dv) == tuple(float(x) for x in jp.ip_zoh_lut[1:])
            assert conv.ip_zoh_poly is None
        else:
            assert conv.ip_zoh_poly is src.ip_zoh_poly
            assert conv.ip_zoh_lut is None
    st, fx, fy = fsm_states(jx)
    tst = convert.state_from_jax(st, DEV)
    args = (torch.from_numpy(fx), torch.from_numpy(fy))
    got = IP.step(convert.params_from_jax(jx.JP.as_population(jp, st.n),
                                          DEV), tst, *args)
    want = IP.step(as_population(port_params(propagator), st.n, DEV), tst,
                   *args)
    np.testing.assert_allclose(got.s.numpy(), want.s.numpy(), rtol=0,
                               atol=TOL)


# ---- the culled path and the chunk -----------------------------------------


def test_build_population_draws_as_jax(jx):
    """`build_population(model="invpendulum")` draws the JAX package's
    `__graft_entry__._build(model_name="invpendulum")` crowd, sized for
    invpendulum."""
    from __graft_entry__ import _build

    _, want = _build(300, np.float64, density=0.02, hist_len=HIST,
                     pad_to_block=128, model_name="invpendulum")
    got = build_population(300, 0.02, HIST, 128, torch.float64, DEV,
                           model="invpendulum")
    for f in ("s", "dest", "destqueue", "nq", "active", "uid", "dyn_x",
              "zrid", "znav", "walk_ok_steps"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.dyn_x.shape[1] == 5 and got.zrid.shape[1] == 2


def ip_engine(params=None, rebuild_every=K, **kw):
    """`bench.py:main_row("invpendulum")`'s engine at a small size."""
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=rebuild_every, screen=False, backend="pallas")
    return TE.Engine.create(params or port_params("poly"),
                            MODELS["invpendulum"],
                            neighbors=TE.NeighborConfig(**{**cfg, **kw}))


def crowd(n, device=DEV, dtype=torch.float32, params=None):
    st = build_population(n, 0.02, HIST, 128, dtype, device,
                          model="invpendulum")
    return prepare(MODELS["invpendulum"], params or port_params("poly"), st)


def test_invpendulum_culled_matches_jax(jx):
    """The slice's path at a small size: 512 riders (a tenth of them
    walking at the start), the poly propagator, the culled stage through
    K1's plain version in float64, 12 steps with rebuilds every 5,
    against JAX's culled engine (its XLA pair path): within 1e-9, and
    1e-9 relative for the latents' steer and roll rates (up to ~500
    rad/s for riders turning hard toward their random destination)."""
    st = crowd(512, dtype=torch.float64)
    jp = jx.JP.InvPendulumBicycleParams.create(zoh_poly=32)
    jst = jx.make_state(st.s[:, :5].numpy(), hist_len=HIST,
                        dtype=np.float64, model=jx.MODELS["invpendulum"])
    jst = jst.replace(dest=jx.jnp.asarray(st.dest.numpy()),
                      destqueue=jx.jnp.asarray(st.destqueue.numpy()))
    jst = jx.prepare(jx.MODELS["invpendulum"], jp, jst)
    assert bool(st.zrid[:, 1].any())
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=K, screen=False)
    jeng = jx.JE.Engine.create(jp, jx.MODELS["invpendulum"],
                               neighbors=jx.JE.NeighborConfig(
                                   backend="xla", **cfg))
    want, _ = jx.jax.jit(lambda e, s: e.simulate(s, STEPS, record=False))(
        jeng, jst)
    got, _ = ip_engine().simulate(st, STEPS, record=False)
    for f in ("s", "dyn_x", "zrid", "walk_ok_steps", "dest", "destpointer",
              "znav", "pos_hist", "i"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("propagator", ["exact", "poly"])
@pytest.mark.parametrize("mode", ["none", "states"])
def test_invpendulum_direct_runner_equals_eager_loop(propagator, mode):
    """The invpendulum chunk behind the runner's static buffers (the chunk
    run in place of a replay) equals the eager loop in every field and
    record."""
    eng = ip_engine(port_params(propagator))
    st = crowd(256, params=port_params(propagator))
    want = eng.simulate(st, STEPS, graph=False, **MODES[mode])
    got = simulate_direct(eng, st, STEPS, mode)
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert isinstance(runner, DirectRunner) and runner.replays == STEPS // K
    assert torch.isfinite(got[0].s).all()


def assert_equal_states(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_poly_coefficients_live_with_their_engine():
    """The engine keeps the coefficient matrix its steps read, which a
    captured chunk reads by address: after 17 engines on other fits have
    stepped and the collector has run, the first engine's matrix is the
    same tensor with the same values, and its step the same bits."""
    eng = ip_engine()
    st = crowd(256)
    first = eng.step(st)
    held = eng.kept_constants(IP.step_constants, eng.params, st)
    alive = weakref.ref(held["poly_coeffs"])
    values = held["poly_coeffs"].clone()
    del held
    for k in range(17):
        other = ip_engine(InvPendulumBicycleParams.create(
            zoh_poly=2, t_s=0.01 + 0.0005 * (k + 1)))
        other.step(st)
    gc.collect()
    assert alive() is not None and torch.equal(alive(), values)
    assert eng.kept_constants(IP.step_constants, eng.params,
                              st)["poly_coeffs"] is alive()
    assert_equal_states(eng.step(st), first)
    # assigning the parameters lets the engine build them anew
    eng.params = eng.params
    assert not eng._columns
    assert_equal_states(eng.step(st), first)


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


CARD_STEPS, CARD_K = 45, 20        # two chunks and a 5-step tail


@pytest.mark.cuda
@pytest.mark.parametrize("propagator", ["exact", "lut", "poly"])
@pytest.mark.parametrize("mode", ["none", "metrics_sorted", "states"])
def test_cuda_invpendulum_graph_equals_eager(cuda_device, propagator, mode):
    """The graphed invpendulum run equals the eager loop bit for bit; the
    capture records one K1 launch per step."""
    params = port_params(propagator)
    if propagator == "lut":           # a capture copies nothing from the host
        tab, v0, dv = params.ip_zoh_lut
        params = params.replace(ip_zoh_lut=(tab.to(cuda_device), v0, dv))
    eng = ip_engine(params, rebuild_every=CARD_K)
    st = crowd(4096, cuda_device, params=params)
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
@pytest.mark.parametrize("propagator", ["exact", "poly"])
def test_cuda_invpendulum_chunk_has_no_sync_point(cuda_device, propagator):
    """One eager invpendulum chunk on the card with every host
    synchronisation an error: the masked squarings, the pivots, the FSM
    and the poly's segment selection included."""
    eng = ip_engine(port_params(propagator), rebuild_every=CARD_K)
    st = crowd(4096, cuda_device, params=port_params(propagator))
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


@pytest.mark.cuda
def test_cuda_poly_graph_replays_after_other_fits(cuda_device):
    """A captured poly chunk replayed after 17 engines on other fits have
    captured, run and been dropped gives the bits of its first run: the
    coefficient matrix it reads by address lives with its engine."""
    eng = ip_engine(rebuild_every=CARD_K)
    st = crowd(4096, cuda_device)
    want = snapshot(*eng.simulate(st, CARD_STEPS, graph=True, record=False))
    for k in range(17):
        other = ip_engine(InvPendulumBicycleParams.create(
            zoh_poly=2, t_s=0.01 + 0.0005 * (k + 1)), rebuild_every=CARD_K)
        other.simulate(st, CARD_STEPS, graph=True, record=False)
        del other
    gc.collect()
    torch.cuda.empty_cache()
    got = eng.simulate(st, CARD_STEPS, graph=True, record=False)
    torch.cuda.synchronize()
    assert_same(*got, want)
