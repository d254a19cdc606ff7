"""PyTorch port: the reference-form pair functions of `ops/forces.py`, the
dense pair stage (`Engine.repulsive_sum`, twod and legacy fields), the
Helbing-Molnar destination force and `state.set_destinations`, held to
the JAX package at float64; and bicycle2d's default engine (dense legacy
field) held to the goldens of the upstream reference."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu import engine as JE  # noqa: E402
from cyclistsocialforce_tpu import make_state as jax_make_state  # noqa: E402
from cyclistsocialforce_tpu import params as JP  # noqa: E402
from cyclistsocialforce_tpu import state as JS  # noqa: E402
from cyclistsocialforce_tpu.models import bicycle2d as jbike  # noqa: E402
from cyclistsocialforce_tpu.ops import forces as JF  # noqa: E402
from cyclistsocialforce_tpu_torch import convert, params, scenarios  # noqa
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch import state as TS  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import forces as TF  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, as_population)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
ATOL = 1e-12
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, atol=ATOL, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


def pair_inputs(seed=0, s=40, r=48):
    """[S, 1] source and [1, R] receiver operands with coincident pairs,
    headings all round the circle."""
    rng = np.random.default_rng(seed)
    xs, ys = rng.uniform(-30, 30, (2, s, 1))
    xr, yr = rng.uniform(-30, 30, (2, 1, r))
    xr[0, :4], yr[0, :4] = xs[:4, 0], ys[:4, 0]       # coincident pairs
    psis = rng.uniform(-np.pi, np.pi, (s, 1))
    psir = rng.uniform(-np.pi, np.pi, (1, r))
    return rng, xr - xs, yr - ys, psis, psir


def test_rep_force_twod_pair_matches_jax():
    """Field parameters drawn inside the validated ranges (sigma_2 <
    sigma_0, sigma_3 < sigma_1: sigma > 0), a zero-amplitude source."""
    rng, dx, dy, psis, psir = pair_inputs()
    s = dx.shape[0]
    f0 = rng.uniform(1, 8, (s, 1))
    f0[5] = 0.0
    cols = [f0, rng.uniform(0.8, 0.99, (s, 1)), rng.uniform(0.1, 0.7, (s, 1)),
            rng.uniform(0.3, 1, (s, 1)), rng.uniform(5, 6, (s, 1)),
            rng.uniform(0.1, 0.3, (s, 1)), rng.uniform(1, 4.9, (s, 1))]
    args = [dx, dy, np.cos(psis), np.sin(psis), np.cos(psir), np.sin(psir),
            *cols]
    want = JF.rep_force_twod_pair(*(jnp.asarray(a) for a in args))
    got = TF.rep_force_twod_pair(*(t(a) for a in args))
    for g, w, name in zip(got, want, ("fx", "fy")):
        close(g, w, name=name)
    assert np.abs(np.asarray(want[0])).max() > 1.0
    assert not np.asarray(want[0])[5].any()           # f_0 = 0 source
    assert got[0][1, 1] == 0 and got[1][2, 2] == 0    # coincident pairs


def test_rep_force_legacy_pair_and_excentricity_match_jax():
    rng, dx, dy, psis, psir = pair_inputs(seed=1)
    s = dx.shape[0]
    v = rng.uniform(-2, 12, s)
    v[:3] = (-0.5, 0.0, 10.0)
    e_w = JF.legacy_excentricity(jnp.asarray(v), 10.0)
    e_g = TF.legacy_excentricity(t(v), 10.0)
    close(e_g, e_w, name="e")
    assert e_g[0] == 0 and e_g[1] == 0 and e_g[2] == 0.7   # v < 0 clamps
    e = np.asarray(e_w)[:, None]
    args = [dx, dy, np.cos(psis), np.sin(psis), e, 1 / np.sqrt(1 - e * e),
            np.full((s, 1), 0.2), np.full((s, 1), 6.0)]
    want = JF.rep_force_legacy_pair(*(jnp.asarray(a) for a in args))
    got = TF.rep_force_legacy_pair(*(t(a) for a in args))
    for g, w, name in zip(got, want, ("fx", "fy")):
        close(g, w, name=name)
    assert np.abs(np.asarray(want[0])).max() > 1.0
    assert got[0][1, 1] == 0 and got[1][2, 2] == 0


@pytest.mark.parametrize("p2r", [False, True])
def test_untracked_foes_tile_and_sum_sources_match_jax(p2r):
    rng = np.random.default_rng(2)
    n = 64
    x, y = rng.uniform(-20, 20, (2, n))
    x[7], y[7] = x[3], y[3]                     # coincident distinct pair
    psi = rng.uniform(-np.pi, np.pi, n)
    idx = np.arange(n)
    active = rng.uniform(size=n) > 0.1
    hfov = rng.uniform(0.5, 2 * np.pi, n)
    args = [x, y, idx, active, hfov, x, y, psi, idx, active]
    want = JF.untracked_foes_tile(*(jnp.asarray(a) for a in args),
                                  priority_p2r=p2r)
    got = TF.untracked_foes_tile(*(t(a) for a in args), priority_p2r=p2r)
    close(got, want, name="untracked")
    assert got[3, 7] and got[7, 3] and got.diagonal().all()
    fx, fy = rng.normal(size=(2, n, n))
    for g, w in zip(TF.sum_sources(t(fx), t(fy), ~got),
                    JF.sum_sources(jnp.asarray(fx), jnp.asarray(fy),
                                   ~want)):
        close(g, w)


def test_dest_force_hm_matches_jax():
    rng = np.random.default_rng(3)
    n = 32
    fxs, fys = rng.normal(size=(2, n)) * 4
    fxs[:3] = fys[:3] = 0.0                      # at the destination
    v, psi = rng.uniform(0, 6, n), rng.uniform(-np.pi, np.pi, n)
    vd = rng.uniform(3, 6, n)
    want = JF.dest_force_hm(*(jnp.asarray(a) for a in (fxs, fys, v, psi, vd)))
    got = TF.dest_force_hm(*(t(a) for a in (fxs, fys, v, psi, vd)))
    for g, w in zip(got, want):
        close(g, w)
    assert not got[0][:3].any()


# ---- the dense pair stage --------------------------------------------------


def crowd(n=96, side=40.0, seed=4, per_agent=False):
    """A small crowd (JAX state and params) with two inactive riders and
    one braking (v < 0)."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, :2] = rng.uniform(0, side, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1, 6, n)
    s0[5, 3] = -0.4
    st = jax_make_state(s0, dtype=jnp.float64, hist_len=8)
    active = np.ones(n, bool)
    active[[2, 11]] = False
    st = st.replace(active=jnp.asarray(active))
    p = JP.BicycleParams.create()
    if per_agent:
        p = JP.as_population(p, n)
        jit = 1 + 0.05 * rng.uniform(-1, 1, n)
        p = p.replace(p_0=p.p_0 * jit, sigma_0=p.sigma_0 * jit,
                      hfov=p.hfov * jit)
    return st, p


@pytest.mark.parametrize("family", ["twod", "legacy"])
@pytest.mark.parametrize("rep_chunk", [None, 32])
@pytest.mark.parametrize("rule,per_agent", [("unregulated", False),
                                            ("p2r", True)])
def test_repulsive_sum_matches_jax(family, rep_chunk, rule, per_agent):
    st, p = crowd(per_agent=per_agent)
    jeng = JE.Engine.create(p, jbike, rep_force=family, rep_chunk=rep_chunk,
                            priority_rule=rule)
    teng = TE.Engine.create(convert.params_from_jax(p, DEV),
                            MODELS["bicycle2d"], rep_force=family,
                            rep_chunk=rep_chunk, priority_rule=rule)
    assert teng.neighbors is None and teng.pair_family == family
    want = jeng.repulsive_sum(st)
    got = teng.repulsive_sum(convert.state_from_jax(st, DEV))
    for g, w in zip(got, want):
        close(g, w)
    assert np.abs(np.asarray(want[0])).max() > 1.0


def test_rep_chunk_must_divide_n():
    st, p = crowd(n=96)
    teng = TE.Engine.create(convert.params_from_jax(p, DEV),
                            MODELS["bicycle2d"], rep_chunk=40)
    with pytest.raises(ValueError, match="rep_chunk"):
        teng.repulsive_sum(convert.state_from_jax(st, DEV))


def test_dense_simulate_record_forces_matches_jax():
    """bicycle2d's default engine (dense legacy field), 30 steps with the
    applied forces recorded, against JAX `simulate`."""
    st, p = crowd(n=64, side=25.0, seed=6)
    jeng = JE.Engine.create(p, jbike)
    want_fin, (wt, wfx, wfy) = jax.jit(
        lambda e, s: e.simulate(s, 30, record_forces=True))(jeng, st)
    teng = TE.Engine.create(convert.params_from_jax(p, DEV),
                            MODELS["bicycle2d"])
    fin, (traj, fx, fy) = teng.simulate(convert.state_from_jax(st, DEV), 30,
                                        record_forces=True)
    assert traj.shape == (30, 64, 8) and fx.shape == (30, 64)
    for g, w, name in ((traj, wt, "traj"), (fx, wfx, "fx"), (fy, wfy, "fy"),
                       (fin.s, want_fin.s, "s"),
                       (fin.pos_hist, want_fin.pos_hist, "pos_hist")):
        close(g, w, atol=1e-10, name=name)


# ---- set_destinations -----------------------------------------------------


def test_set_destinations_matches_jax():
    s0 = np.array([[-6., 0, 0, 5, 0], [15., -20, np.pi / 2, 5, 0],
                   [13., -20, np.pi / 2, 5, 0]])
    jst = jax_make_state(s0, dtype=jnp.float64, queue_size=6, hist_len=8)
    tst = TS.make_state(s0, dtype=torch.float64, queue_size=6, hist_len=8,
                        device=DEV)
    for kw in (dict(agent=0, x=(35, 64, 65), y=(0, 0, 0)),
               dict(agent=1, x=(15, 15), y=(20, 49), stop=(0, 1)),
               dict(agent=1, x=(1,), y=(2,), stop=(1,)),
               dict(agent=2, x=(13, 13), y=(20, 49), stop=(0, 1),
                    reset=True)):
        jst = JS.set_destinations(jst, **kw)
        tst = TS.set_destinations(tst, **kw)
        for f in ("destqueue", "nq", "destpointer", "dest"):
            close(getattr(tst, f), getattr(jst, f), atol=0, name=f)
    with pytest.raises(ValueError, match="overflow"):
        TS.set_destinations(tst, 1, (1, 2, 3), (1, 2, 3))
    with pytest.raises(ValueError, match="queue size"):
        TS.set_destinations(tst, 1, range(7), range(7), reset=True)


def test_entry_points_default_to_the_card():
    """The port runs on the card unless the caller asks for the CPU."""
    for fn in (TS.make_state, scenarios.build_population,
               params.as_population, convert.state_from_jax,
               convert.params_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TS.make_state(np.zeros((2, 5)))


# ---- goldens of the upstream reference --------------------------------------


def load_golden(name):
    path = os.path.join(GOLDEN, name)
    if not os.path.exists(path):
        pytest.skip(f"golden file {name} missing")
    return np.load(path)


def encroachment_port(n_steps=700):
    """The 3-rider encroachment scenario of
    tests/test_parity_bicycle2d.py through the port's dense default
    engine (legacy field)."""
    s0 = np.array([[-6.0, 0, 0, 5, 0], [15.0, -20, np.pi / 2, 5, 0],
                   [13.0, -20, np.pi / 2, 5, 0]])
    st = TS.make_state(s0, dtype=torch.float64, device=DEV)
    st = TS.set_destinations(st, 0, (35, 64, 65), (0, 0, 0))
    st = TS.set_destinations(st, 1, (15, 15, 15), (20, 49, 50))
    st = TS.set_destinations(st, 2, (13, 13, 13), (20, 49, 50))
    p = as_population(BicycleParams.create(), 3, DEV)
    p = p.replace(v_desired_default=torch.tensor([4.5, 5.0, 5.0],
                                                 dtype=torch.float64))
    eng = TE.Engine.create(p, MODELS["bicycle2d"])
    assert eng.pair_family == "legacy" and eng.neighbors is None
    _, (traj, fx, fy) = eng.simulate(st, n_steps, record_forces=True)
    return traj.numpy(), fx.numpy(), fy.numpy()


def test_encroachment_bicycle2d_golden_and_jax():
    """At the JAX test's bars against the reference
    (tests/test_parity_bicycle2d.py), and against JAX's own trajectory
    at 1e-10."""
    from test_parity_bicycle2d import run_encroachment

    g = load_golden("encroachment_bicycle2d.npz")
    traj, fx, fy = encroachment_port()
    for a in range(3):
        ref = g[f"traj_{a}"]
        got = traj[:, a, :5]
        pos_err = np.max(np.hypot(got[:, 0] - ref[0, 1:],
                                  got[:, 1] - ref[1, 1:]))
        assert pos_err < 1e-3, f"agent {a}: max position error {pos_err}"
        np.testing.assert_allclose(got[:, 3], ref[3, 1:], atol=1e-6)
        np.testing.assert_allclose(np.sin(got[:, 2]), np.sin(ref[2, 1:]),
                                   atol=1e-6)
        np.testing.assert_allclose(fx[:, a], g[f"forces_{a}"][0, 1:],
                                   atol=1e-6)
    jtraj, jfx, jfy = run_encroachment("bicycle2d")
    np.testing.assert_allclose(traj, jtraj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(fx, jfx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(fy, jfy, rtol=0, atol=1e-10)


def test_hm_single_golden():
    """dest_force="hm", one rider (tests/test_parity_bicycle2d.py)."""
    g = load_golden("hm_single.npz")
    n_steps = g["traj_0"].shape[1] - 1
    st = TS.make_state(np.array([[0.0, 0, 0, 3, 0]]), dtype=torch.float64,
                       device=DEV)
    st = TS.set_destinations(st, 0, (20, 40, 40), (0, 10, 11))
    p = as_population(BicycleParams.create(), 1, DEV)
    p = p.replace(v_desired_default=torch.tensor([4.0], dtype=torch.float64))
    eng = TE.Engine.create(p, MODELS["bicycle2d"], dest_force="hm")
    _, (traj, fx, fy) = eng.simulate(st, n_steps, record_forces=True)
    traj, fx, fy = traj.numpy(), fx.numpy(), fy.numpy()
    ref = g["traj_0"]
    pos_err = np.max(np.hypot(traj[:, 0, 0] - ref[0, 1:],
                              traj[:, 0, 1] - ref[1, 1:]))
    assert pos_err < 1e-3, f"max position error {pos_err}"
    np.testing.assert_allclose(traj[:, 0, 3], ref[3, 1:], atol=1e-6)
    np.testing.assert_allclose(np.sin(traj[:, 0, 2]), np.sin(ref[2, 1:]),
                               atol=1e-6)
    np.testing.assert_allclose(fx[:, 0], g["forces_0"][0, 1:], atol=1e-6)
    np.testing.assert_allclose(fy[:, 0], g["forces_0"][1, 1:], atol=1e-6)


def test_field_legacy_golden():
    """`rep_tile_legacy` of one rider on the golden's grid against the
    reference Bicycle.calcRepulsiveForce, where the golden is finite (it
    is NaN at rho = 0)."""
    g = load_golden("field_legacy.npz")
    st = TS.make_state(g["s"][None], dtype=torch.float64, device=DEV)
    p = as_population(BicycleParams.create(), 1, DEV)
    eng = TE.Engine.create(p, MODELS["bicycle2d"])
    s = st.s
    src = (s[:, 0], s[:, 1], s[:, 2], s[:, 3])
    gx, gy = t(g["gx"]).reshape(-1), t(g["gy"]).reshape(-1)
    zero = torch.zeros_like(gx)
    fpx, fpy = eng.rep_force(eng.params, src, (gx, gy, zero, zero))
    for got, name in ((fpx, "Fx"), (fpy, "Fy")):
        want = g[name].reshape(-1)
        ok = np.isfinite(want)
        assert ok.sum() > 1000
        np.testing.assert_allclose(got.sum(dim=0).numpy()[ok], want[ok],
                                   rtol=0, atol=1e-12)
