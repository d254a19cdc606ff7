"""PyTorch port: the balancing rider's stochastic control behavior and its
torque disturbances held to the JAX package in float64 on the CPU.

The port draws JAX's random streams (`ops.random`, `state.agent_streams`:
threefry of (key, t_glob, uid, salt)), so both packages resample the same
riders with the same features from `make_state(seed=)`: `create` in each
stochastic mode against JAX's (the Ackermann basis table and fit, the pole
model); `prepare` (each rider's initial draw) and one step of each mode at
1e-12; trajectories at 1e-9 m over 300 steps in the dense (exact), budget
binding and not binding, cadence, `gains_poly` and `gains_lut` basis and
disturbance modes, their resampling and Bernoulli outcomes equal; the
draws of a row-shuffled population equal per uid bit for bit, and so the
final states of a sorted-resident culled run and of a run on shuffled
rows; the mirrors of tests/test_parity_balancingrider.py (stability,
budget deferral, cadence, disturbances, the relaxed and exact rows'
distributions); a stochastic group in a `MixedEngine` against JAX's (the
key folded with the group); the refusals that stay (`prop_lut` /
`prop_poly` with stochastic behavior, `scripted=`); the chunk behind the
runner's static buffers and the cadence decided on the host against the
eager loop and the cadence decided on the device. On the card (`cuda`):
the graphed stochastic rows against the eager loop bit for bit, and a
chunk with every host synchronisation an error.
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
from cyclistsocialforce_tpu_torch.models import \
    balancingrider as BR  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import random as R  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BalancingRiderParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import (  # noqa: E402
    STOCHASTIC_ROWS, stochastic_row)
from cyclistsocialforce_tpu_torch.state import make_state  # noqa: E402
from test_torch_graph import (MODES, assert_same,  # noqa: E402
                              simulate_direct, snapshot)
from test_torch_twod import (ENCROACH_DESTS, ENCROACH_S0,  # noqa: E402
                             run_scenario_port)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = 1e-12
ENCROACH_V = [4.5, 5.0, 5.0]
# a tight hysteresis: the encroachment riders resample every few steps
STOCH = dict(stochastic_control_behavior=True,
             controlparam_resampling_speedthresh=0.05)
DIST = dict(p_dist_roll=0.05, p_dist_steer=0.05, T_dist_roll=20.0,
            T_dist_steer=20.0)
# the stochastic modes: create() keywords
MODES_STOCH = {
    "exact": STOCH,
    "budget_binding": {**STOCH, "resample_budget": 1},
    "budget_free": {**STOCH, "resample_budget": 8},
    "cadence": {**STOCH, "resample_budget": 2, "resample_every": 4},
    "gains_poly": {**STOCH, "gains_poly": 16},
    "gains_lut": {**STOCH, "gains_lut": 512},
    "disturb": {**STOCH, **DIST},
    "disturb_only": DIST,
}


@pytest.fixture
def jx():
    """The JAX package's modules and test helpers used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import parity_common

    from cyclistsocialforce_tpu import engine, make_state, mixed, params
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import balancingrider as JBR
    from cyclistsocialforce_tpu.models import prepare as jprepare
    from cyclistsocialforce_tpu.state import agent_streams, set_destinations

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JE=engine, JP=params, JM=mixed, JBR=JBR,
        make_state=make_state, MODELS=JMODELS, prepare=jprepare,
        agent_streams=agent_streams, set_destinations=set_destinations,
        pc=parity_common)


@functools.lru_cache(maxsize=None)
def port_params(mode):
    return BalancingRiderParams.create(**MODES_STOCH[mode])


def jax_params(jx, mode):
    return jx.JP.BalancingRiderParams.create(verbose=False,
                                             **MODES_STOCH[mode])


def assert_rel(got, want, tol=TOL):
    """|got - want| <= tol * max(1, max |want|)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# ---- create and the refusals ---------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES_STOCH))
def test_create_matches_jax(jx, mode):
    """The stochastic fields of `create`: the flag, the hysteresis, budget,
    cadence, the disturbance probabilities and torques and their flag, the
    pole model, and the Ackermann basis table ([G, 6, 5], within 1e-12 of
    JAX's relative to each row) or fit (coefficients within 1e-12 of the
    largest); the deterministic tables and fits absent."""
    got, want = port_params(mode), jax_params(jx, mode)
    for f in ("stochastic_control_behavior", "br_resample_budget",
              "br_resample_every", "br_disturb"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("controlparam_resampling_speedthresh", "p_dist_roll",
              "p_dist_steer", "T_dist_roll", "T_dist_steer"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    assert (got.polemodel_rt is None) == (want.polemodel_rt is None)
    if want.polemodel_rt is not None:
        assert_rel(got.polemodel_rt.cov_chol, want.polemodel_rt.cov_chol)
    for f in ("br_gains_lut", "br_gains_poly", "br_prop_lut",
              "br_prop_poly"):
        assert (getattr(got, f) is None) == (getattr(want, f) is None), f
    g, w = got.br_ackermann_lut, want.br_ackermann_lut
    assert (g is None) == (w is None)
    if w is not None:
        tab, wtab = g[0].numpy(), np.asarray(w[0])
        assert tab.shape == wtab.shape == (512, 6, 5)
        assert (g[1], g[2]) == (float(w[1]), float(w[2]))
        flat, wflat = tab.reshape(512, 30), wtab.reshape(512, 30)
        rel = np.abs(flat - wflat).max(axis=1) / np.abs(wflat).max(axis=1)
        assert rel.max() <= TOL and np.isfinite(tab).all()
    g, w = got.br_ackermann_poly, want.br_ackermann_poly
    assert (g is None) == (w is None)
    if w is not None:
        assert g[1:] == w[1:]
        C, Cj = np.asarray(g[0]), np.asarray(w[0])
        assert C.shape == Cj.shape
        assert np.abs(C - Cj).max() <= TOL * np.abs(Cj).max()


def test_refusals_that_stay():
    """`prop_lut` and `prop_poly` with stochastic behavior raise JAX's
    ValueError; a `scripted=` that is not a `ScriptedTraj` raises
    TypeError in `Engine.create` and `MixedEngine.create` (scripted
    agents are ported: tests/test_torch_scripted.py)."""
    for kw in ({"prop_lut": 256}, {"prop_poly": 16}):
        with pytest.raises(ValueError, match="prop"):
            BalancingRiderParams.create(stochastic_control_behavior=True,
                                        **kw)
    model = MODELS["balancingrider"]
    with pytest.raises(TypeError, match="ScriptedTraj"):
        TE.Engine.create(port_params("exact"), model, scripted=object())
    with pytest.raises(TypeError, match="ScriptedTraj"):
        MixedEngine.create([(model, port_params("exact"), 2)],
                           scripted=object())


# ---- prepare and one step ------------------------------------------------------


def step_inputs(jx, mode, n=40, seed=5):
    """A JAX float64 balancing-rider state made with `make_state(seed=)`
    and prepared in `mode` (each rider's initial draw), random latents,
    speeds 2-8 m/s and a quarter of the riders needy (their last
    resampling 1 m/s away); forces, every third rider commanded its own
    speed (the gains hold)."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 8))
    s0[:, :2] = rng.uniform(-20, 20, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = np.linspace(2.0, 8.0, n)
    s0[:, 4:8] = rng.uniform(-0.2, 0.2, (n, 4))
    st = jx.make_state(s0, dtype=np.float64, hist_len=8, seed=seed,
                       model=jx.MODELS["balancingrider"])
    st = jx.prepare(jx.MODELS["balancingrider"], jax_params(jx, mode), st)
    dg = np.asarray(st.dyn_gains).copy()
    dg[::4, 10] -= 1.0
    st = st.replace(dyn_gains=jx.jnp.asarray(dg),
                    t_glob=jx.jnp.asarray(12, jx.jnp.int32))
    fx, fy = rng.normal(0, 4, n), rng.normal(0, 4, n)
    hold = np.arange(n) % 3 == 0
    fx[hold], fy[hold] = s0[hold, 3], 0.0
    return st, fx, fy


@pytest.mark.parametrize("mode", sorted(MODES_STOCH))
def test_prepare_matches_jax(jx, mode):
    """`prepare` from `make_state(seed=)` on both sides: the initial pole
    features (salt 3), their speed and the exact gains at 1e-12."""
    rng = np.random.default_rng(2)
    s0 = np.c_[rng.uniform(0, 50, (30, 2)), rng.uniform(-1, 1, 30),
               np.linspace(0.5, 9.0, 30)]
    jst = jx.make_state(s0, dtype=np.float64, seed=17,
                        model=jx.MODELS["balancingrider"])
    want = jx.prepare(jx.MODELS["balancingrider"], jax_params(jx, mode), jst)
    tst = make_state(s0, dtype=torch.float64, device=DEV, seed=17,
                     model=MODELS["balancingrider"])
    assert torch.equal(tst.key, convert.state_from_jax(jst, DEV).key)
    got = prepare(MODELS["balancingrider"], port_params(mode), tst)
    for f in ("dyn_x", "dyn_v", "dyn_gains"):
        assert_rel(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("per_rider", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES_STOCH))
def test_one_step_matches_jax(jx, mode, per_rider):
    """One `step` of each mode against JAX's at 1e-12, shared and per-rider
    parameters, at a global step (12) where the cadence of 4 fires; in
    the cadence mode also at 13, where it does not, with the step told the
    clock on the host (`t_host`) and deciding on the device."""
    st, fx, fy = step_inputs(jx, mode)
    jp, tp = jax_params(jx, mode), port_params(mode)
    if per_rider:
        jp = jx.JP.as_population(jp, st.n)
        tp = as_population(tp, st.n, DEV)
    clocks = (12, 13) if mode == "cadence" else (12,)
    for t in clocks:
        jst = st.replace(t_glob=jx.jnp.asarray(t, jx.jnp.int32))
        want = jx.jax.jit(jx.MODELS["balancingrider"].step)(
            jp, jst, jx.jnp.asarray(fx), jx.jnp.asarray(fy))
        tst = convert.state_from_jax(jst, DEV)
        args = (torch.from_numpy(fx), torch.from_numpy(fy))
        got = BR.step(tp, tst, *args)
        for f in ("s", "dyn_x", "dyn_v", "dyn_gains"):
            assert_rel(getattr(got, f), getattr(want, f))
        host = BR.step(tp, tst, *args, t_host=t)
        for f in ("s", "dyn_x", "dyn_gains"):
            assert torch.equal(getattr(host, f), getattr(got, f)), f


def test_disturbance_draws_match_jax(jx):
    """The Bernoulli outcomes: one uniform pair per rider under salt 1,
    compared with p_dist_roll and p_dist_steer, as JAX draws them."""
    n, p = 5000, port_params("disturb")
    uid = torch.from_numpy(np.random.default_rng(1).permutation(n)
                           .astype(np.int32))
    tst = make_state(np.zeros((n, 4)), dtype=torch.float64, device=DEV,
                     seed=3)
    tst = tst.replace(uid=uid, t_glob=torch.tensor(9, dtype=torch.int32))
    t_roll, t_steer = BR._disturbances(p, tst)
    keys = jx.agent_streams(jx.jax.random.PRNGKey(3),
                            jx.jnp.asarray(9, jx.jnp.int32),
                            jx.jnp.asarray(uid.numpy()), 1)
    uu = np.asarray(jx.jax.vmap(lambda k: jx.jax.random.uniform(
        k, (2,), jx.jnp.float64))(keys))
    np.testing.assert_array_equal(t_roll.numpy() != 0, uu[:, 0] < 0.05)
    np.testing.assert_array_equal(t_steer.numpy() != 0, uu[:, 1] < 0.05)
    assert 150 < int((t_roll != 0).sum()) < 350
    assert set(t_roll.unique().tolist()) == {0.0, 20.0}


# ---- trajectories --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def port_run(mode, steps=300):
    return run_scenario_port("balancingrider", port_params(mode),
                             ENCROACH_S0, ENCROACH_DESTS, steps, ENCROACH_V)


@pytest.mark.parametrize("mode", sorted(MODES_STOCH))
def test_trajectories_match_jax(jx, mode):
    """The encroachment scenario (3 riders, hysteresis 0.05 m/s) through
    both packages at float64, 300 steps, each mode: every position within
    1e-9 m, every state and force within 1e-9; the riders did resample
    (or were disturbed) along the way."""
    want = jx.pc.run_scenario("balancingrider", jax_params(jx, mode),
                              ENCROACH_S0, ENCROACH_DESTS, 300,
                              v_desired=ENCROACH_V)
    got = port_run(mode)
    pos = np.hypot(got[0][..., 0] - want[0][..., 0],
                   got[0][..., 1] - want[0][..., 1])
    assert pos.max() < 1e-9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    assert np.isfinite(got[0]).all()
    if "disturb" in mode:
        calm = run_scenario_port(
            "balancingrider", BalancingRiderParams.create(
                **{k: v for k, v in MODES_STOCH[mode].items()
                   if not k.startswith(("p_dist", "T_dist"))}),
            ENCROACH_S0, ENCROACH_DESTS, 300, ENCROACH_V)
        assert np.abs(got[0] - calm[0]).max() > 1e-4


def test_resampling_happens_in_the_scenario():
    """In the exact mode the three riders resample repeatedly: their
    stored pole features at the end differ from the mean functions'."""
    st = make_state(np.asarray(ENCROACH_S0), dtype=torch.float64,
                    device=DEV)
    p = port_params("exact")
    st = prepare(MODELS["balancingrider"], as_population(p, 3, DEV), st)
    c = BR.step_constants(p, torch.float64, DEV)["constants"]
    lin = c["pole_lin"][..., 0] + c["pole_lin"][..., 1] * st.s[:, 3:4]
    assert (st.dyn_gains[:, BR._PF] - lin).abs().max() > 1e-3


# ---- the budget, the cadence and the JAX package's own checks -------------------


def needy_state(n, seed, budget, every, needy, t=0):
    """n riders at 4-6 m/s, prepared, with the riders `needy` made needy
    (their last resampling 2 m/s below their speed), at global step t."""
    params = BalancingRiderParams.create(
        stochastic_control_behavior=True, resample_budget=budget,
        resample_every=every)
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 8))
    s0[:, 3] = rng.uniform(4, 6, n)
    st = BR.prepare(params, make_state(s0, dtype=torch.float64, device=DEV))
    v = st.s[:, 3].clone()
    dg = st.dyn_gains.clone()
    dg[needy, BR._VLAST] = v[needy] - 2.0
    return params, st.replace(dyn_gains=dg, t_glob=torch.tensor(
        t, dtype=torch.int32)), v


def test_budget_defers_in_index_order():
    """tests/test_parity_balancingrider.py's budget test: with 6 needy
    riders and a budget of 4 the first four by row are resampled, 9 and 11
    deferred, and picked up on the next call."""
    needy = [1, 3, 5, 7, 9, 11]
    params, st, v = needy_state(16, 0, 4, 1, needy)
    c = BR.step_constants(params, torch.float64, DEV)["constants"]
    gate = torch.ones(16, dtype=torch.bool)
    feats, st2 = BR._pole_features(params, c, st, v, gate)
    updated = st2.dyn_gains[:, BR._VLAST] == v
    assert torch.where(~updated)[0].tolist() == [9, 11]
    assert torch.isfinite(feats).all()
    _, st3 = BR._pole_features(params, c, st2, v, gate)
    assert (st3.dyn_gains[:, BR._VLAST] == v).all()


@pytest.mark.parametrize("host_clock", [False, True])
def test_cadence_fires_on_the_global_step(host_clock):
    """tests/test_parity_balancingrider.py's cadence test: with a cadence
    of 3 and a budget of 8 of 16 needy riders, nothing is resampled at
    t = 1 and 2, the first 8 at t = 3; the same whether the step is told
    the clock on the host or reads it on the device."""
    c = None
    for t, fires in ((1, False), (2, False), (3, True)):
        params, st, v = needy_state(16, 1, 8, 3, list(range(16)), t)
        if c is None:
            c = BR.step_constants(params, torch.float64, DEV)["constants"]
        _, out = BR._pole_features(params, c, st, v,
                                   torch.ones(16, dtype=torch.bool),
                                   t if host_clock else None)
        updated = out.dyn_gains[:, BR._VLAST] == v
        assert bool(updated.any()) == fires
        if fires:
            assert torch.where(updated)[0].tolist() == list(range(8))


def stable_run(params, steps):
    """tests/test_parity_balancingrider.py's stable-run scenario on the
    port: (traj, fx, fy)."""
    return run_scenario_port("balancingrider", params, ENCROACH_S0,
                             ENCROACH_DESTS, steps, ENCROACH_V)


@pytest.mark.parametrize("budget", [0, 2])
def test_stochastic_runs_stay_stable(budget):
    """The stability checks of tests/test_parity_balancingrider.py: 400
    steps with a 0.5 m/s hysteresis, dense and with a budget of 2: finite,
    roll under pi/3."""
    traj = stable_run(BalancingRiderParams.create(
        stochastic_control_behavior=True, resample_budget=budget,
        controlparam_resampling_speedthresh=0.5), 400)[0]
    assert np.isfinite(traj).all()
    assert np.abs(traj[:, :, 5]).max() < np.pi / 3


def test_torque_disturbances_perturb():
    """tests/test_parity_balancingrider.py's disturbance test: steer
    torques (p 0.02, 20 N m) on the deterministic rider change the 200-step
    run by more than 1e-4 and keep it finite."""
    base = stable_run(BalancingRiderParams.create(), 200)[0]
    pert = stable_run(BalancingRiderParams.create(p_dist_steer=0.02,
                                                  T_dist_steer=20.0), 200)[0]
    assert np.isfinite(pert).all()
    assert np.abs(pert - base).max() > 1e-4


def test_relaxed_and_exact_rows_agree_in_distribution():
    """tests/test_parity_balancingrider.py's distribution test on the port,
    at a third of its horizon: 512 stable riders, 0.3 m/s hysteresis, the
    exact semantics against a cadence of 4 and a budget of 64, 120 steps
    on the culled stage: the pole features of the population and the
    final speeds and lateral positions indistinguishable (two-sample KS,
    p > 1e-3)."""
    from scipy import stats

    n = 512
    rng = np.random.default_rng(7)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, 150, n)
    s0[:, 1] = rng.uniform(0, 150, n)
    s0[:, 2] = rng.uniform(-0.2, 0.2, n)
    s0[:, 3] = rng.uniform(4, 6, n)
    dst = np.c_[s0[:, 0] + 300, s0[:, 1] + rng.uniform(-5, 5, n),
                np.zeros(n)]

    def run(every, budget):
        p = BalancingRiderParams.create(
            stochastic_control_behavior=True, resample_budget=budget,
            resample_every=every, controlparam_resampling_speedthresh=0.3)
        st = make_state(s0, dtype=torch.float64, hist_len=8, device=DEV)
        d = torch.from_numpy(dst)
        dq = st.destqueue.clone()
        dq[:, 0, :] = d
        st = prepare(MODELS["balancingrider"], p,
                     st.replace(dest=d, destqueue=dq))
        eng = TE.Engine.create(p, MODELS["balancingrider"],
                               neighbors=TE.NeighborConfig(
                                   cutoff=50.0, block=128, block_src=64,
                                   kb=24, rebuild_every=20, screen=False))
        return eng.simulate(st, 120, record=False)[0]

    exact, perf = run(1, 0), run(4, 64)
    for out in (exact, perf):
        assert torch.isfinite(out.s).all()
    for a, b in zip(exact.dyn_gains[:, BR._PF].T, perf.dyn_gains[:, BR._PF].T):
        assert stats.ks_2samp(a.numpy(), b.numpy()).pvalue > 1e-3
    for col in (3, 1):
        assert stats.ks_2samp(exact.s[:, col].numpy(),
                              perf.s[:, col].numpy()).pvalue > 1e-3


# ---- permutation invariance ------------------------------------------------------


def spread_crowd(n=256, seed=3):
    """n riders on a 120 m grid (no pair force reaches another rider),
    4-6 m/s toward a destination 100 m ahead, prepared in the budget-free
    cadence mode with disturbances."""
    params = BalancingRiderParams.create(
        stochastic_control_behavior=True, resample_budget=n,
        resample_every=4, controlparam_resampling_speedthresh=0.05, **DIST)
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    s0 = np.zeros((n, 5))
    s0[:, 0] = 120.0 * (np.arange(n) % side)
    s0[:, 1] = 120.0 * (np.arange(n) // side)
    s0[:, 2] = rng.uniform(-0.2, 0.2, n)
    s0[:, 3] = rng.uniform(4, 6, n)
    st = make_state(s0, dtype=torch.float64, hist_len=8, device=DEV, seed=9,
                    model=MODELS["balancingrider"])
    d = torch.from_numpy(np.c_[s0[:, 0] + 100, s0[:, 1], np.zeros(n)])
    dq = st.destqueue.clone()
    dq[:, 0, :] = d
    st = st.replace(dest=d, destqueue=dq)
    return params, prepare(MODELS["balancingrider"], params, st)


def test_shuffled_rows_give_the_same_riders():
    """The sorted-resident culled run (rows permuted by cell every chunk)
    and a run from a row-shuffled state: every per-uid field bit-equal
    after 45 steps (riders out of each other's range: the draws, the
    cadence and the disturbances are all that could differ)."""
    params, st = spread_crowd()
    eng = TE.Engine.create(params, MODELS["balancingrider"],
                           neighbors=TE.NeighborConfig(
                               cutoff=50.0, block=128, block_src=64, kb=8,
                               rebuild_every=20, screen=False))
    perm = torch.from_numpy(np.random.default_rng(4).permutation(st.n))
    a, _ = eng.simulate(st, 45, record=False)
    b, _ = eng.simulate(TE.permute_state(st, perm), 45, record=False)
    ia, ib = torch.argsort(a.uid.long()), torch.argsort(b.uid.long())
    for f in TE._PER_AGENT_FIELDS:
        assert torch.equal(getattr(a, f)[ia], getattr(b, f)[ib]), f
    assert (a.dyn_gains[:, BR._VLAST] != st.dyn_gains[:, BR._VLAST]).any()


# ---- MixedEngine ---------------------------------------------------------------


def test_mixed_stochastic_group_matches_jax(jx):
    """A `MixedEngine` of 4 bicycle2d riders and 6 stochastic balancing
    riders with disturbances (the master key folded with the group index,
    as JAX's MixedEngine gives it), 150 dense steps from `make_state(seed=
    2)`: every position within 1e-9 m of JAX's."""
    rng = np.random.default_rng(14)
    n = 10
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, 25, n)
    s0[:, 1] = rng.uniform(0, 25, n)
    s0[:, 2] = rng.uniform(-0.2, 0.2, n)
    s0[:, 3] = rng.uniform(4.0, 5.5, n)
    jst = jx.make_state(s0, dtype=np.float64, seed=2)
    for a in range(n):
        jst = jx.set_destinations(jst, a, (float(s0[a, 0]) + 40.0,),
                                  (float(s0[a, 1]),))
    groups = [("bicycle2d", jx.JP.as_population(
                   jx.JP.BicycleParams.create(), 4), 4),
              ("balancingrider", jx.JP.as_population(
                  jax_params(jx, "disturb"), 6), 6)]
    jeng = jx.JM.MixedEngine.create(groups)
    jst = jx.JM.prepare_groups(jeng, jst)
    _, want = jx.jax.jit(lambda s: jeng.simulate(s, 150))(jst)
    specs = convert.group_specs_from_jax(jeng, DEV)
    eng = MixedEngine.create(specs)
    fresh = jx.make_state(s0, dtype=np.float64, seed=2)
    st = prepare_groups(eng, convert.state_from_jax(fresh.replace(
        destqueue=jst.destqueue, dest=jst.dest, nq=jst.nq), DEV))
    _, traj = eng.simulate(st, 150)
    want = np.asarray(want)
    pos = np.hypot(*(traj.numpy() - want)[..., :2].transpose(2, 0, 1))
    assert pos.max() < 1e-9
    assert np.isfinite(traj.numpy()).all()


@pytest.mark.parametrize("mode", ["exact", "gains_lut", "disturb"])
def test_params_from_jax_carries_the_stochastic_fields(jx, mode):
    """`convert.params_from_jax` of stochastic JAX params, shared and per
    rider: the pole model, the basis table or fit, budget and cadence; the
    step on the converted params equals the step on the port's own."""
    jp = jax_params(jx, mode)
    st, fx, fy = step_inputs(jx, mode)
    tst = convert.state_from_jax(st, DEV)
    args = (torch.from_numpy(fx), torch.from_numpy(fy))
    for src, own in ((jp, port_params(mode)),
                     (jx.JP.as_population(jp, st.n),
                      as_population(port_params(mode), st.n, DEV))):
        conv = convert.params_from_jax(src, DEV)
        assert conv.stochastic_control_behavior is own.\
            stochastic_control_behavior
        assert conv.br_resample_every == own.br_resample_every
        got = BR.step(conv, tst, *args)
        want = BR.step(own, tst, *args)
        for f in ("s", "dyn_x", "dyn_gains"):
            assert_rel(getattr(got, f), getattr(want, f))


# ---- the chunk ------------------------------------------------------------------


@pytest.mark.parametrize("row", sorted(STOCHASTIC_ROWS))
def test_direct_runner_equals_eager_loop(row):
    """bench.py's two stochastic rows at 512 riders (budget 64 for the
    relaxed one): the chunk behind the runner's static buffers (captured
    at the clock's phase) equals the eager loop, which equals the loop
    whose step decides the cadence on the device; two chunks and a tail
    from t_glob = 3 (phase 3 of the cadence)."""
    kw = {"resample_budget": 64} if row == "stochastic" else {}
    eng, st = stochastic_row(row, 512, dtype=torch.float64, device=DEV,
                             **kw)
    eng.neighbors = TE.NeighborConfig(cutoff=50.0, block=128, block_src=64,
                                      kb=19, rebuild_every=5, screen=False)
    st = st.replace(t_glob=torch.tensor(3, dtype=torch.int32))
    want = eng.simulate(st, 12, graph=False, **MODES["states"])
    got = simulate_direct(eng, st, 12, "states")
    assert_same(*got, snapshot(*want))
    phases = sorted(k[3] for k in eng._runners)
    assert phases == ([0, 3] if row == "stochastic" else [None])
    device_clock = eng.with_params(eng.params)
    device_clock.clock_hook = None
    assert_same(*device_clock.simulate(st, 12, graph=False,
                                       **MODES["states"]), snapshot(*want))
    assert torch.isfinite(got[0].s).all()


# ---- the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("row", sorted(STOCHASTIC_ROWS))
@pytest.mark.parametrize("rec", ["none", "states"])
def test_cuda_stochastic_graph_equals_eager(cuda_device, row, rec):
    """bench.py's stochastic rows at 4,096 riders on the card: the graphed
    run equals the eager loop bit for bit, one K1 launch per captured
    step."""
    eng, st = stochastic_row(row, 4096, device=cuda_device)
    want = eng.simulate(st, 45, graph=False, **MODES[rec])
    PF.reset_launches()
    got = eng.simulate(st, 45, graph=True, **MODES[rec])
    torch.cuda.synchronize()
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert runner.captured == (20, 0, 0)
    assert torch.isfinite(got[0].s).all()


@pytest.mark.cuda
@pytest.mark.parametrize("row", sorted(STOCHASTIC_ROWS))
def test_cuda_stochastic_chunk_has_no_sync_point(cuda_device, row):
    """One eager chunk of each stochastic row on the card with every host
    synchronisation an error: the threefry streams, the compaction, the
    sampler and the cadence decided on the device."""
    eng, st = stochastic_row(row, 4096, device=cuda_device)
    cache = eng.neighbor_cache(st)
    st = TE.permute_state(st, cache[0])
    eng.run_chunk(st, cache, 1, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.run_chunk(st, cache, 20, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.s).all()


@pytest.mark.cuda
def test_cuda_draws_match_the_cpu(cuda_device):
    """The card's threefry words and float32/float64 uniforms equal the
    CPU's bit for bit (integer arithmetic and exact scaling)."""
    keys = R.split(R.key(5, "cpu"), 1000)
    for dtype in (torch.float32, torch.float64):
        cpu = R.uniform(keys, (8, 5), dtype)
        card = R.uniform(keys.to(cuda_device), (8, 5), dtype)
        assert torch.equal(card.cpu(), cpu)
