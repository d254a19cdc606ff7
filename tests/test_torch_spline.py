"""PyTorch port: the spline path-planning pieces, each held to the JAX
function on the same seeded numpy inputs at float64 (rtol = atol =
1e-12, as tests/test_spline.py holds the JAX fits; non-finite values at
the same places, integers and booleans exactly): `ops.smallmat.solve_small`,
`ops.spline` whole, `engine.dest_force_spline` stage by stage, the
trajectory prototype, `state.set_spline_destinations` and
`InvPendulumBicycleParams`."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu import engine as JE  # noqa: E402
from cyclistsocialforce_tpu import make_state as jax_make_state  # noqa: E402
from cyclistsocialforce_tpu import params as JP  # noqa: E402
from cyclistsocialforce_tpu import state as JS  # noqa: E402
from cyclistsocialforce_tpu import trajectory as JT  # noqa: E402
from cyclistsocialforce_tpu.ops import smallmat as JSM  # noqa: E402
from cyclistsocialforce_tpu.ops import spline as JSP  # noqa: E402
from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch import params as TP  # noqa: E402
from cyclistsocialforce_tpu_torch import state as TS  # noqa: E402
from cyclistsocialforce_tpu_torch import trajectory as TT  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import smallmat as TSM  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import spline as TSP  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = dict(rtol=1e-12, atol=1e-12)


def close(got, want, **tol):
    """Equal within the tolerance, non-finite values at the same places
    (NaN where NaN, the same infinities)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, equal_nan=True,
                                   **(tol or TOL))


def t64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def vmapped(fn, *args):
    return jax.vmap(fn)(*(jnp.asarray(a) for a in args))


def points(n, m, seed, spread=10.0):
    """[n, m, 2] support points along noisy forward paths (distinct,
    increasing chord parameter)."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0.5, 3.0, (n, m, 1)) * np.stack(
        [np.cos(rng.uniform(-0.6, 0.6, (n, m))),
         np.sin(rng.uniform(-0.6, 0.6, (n, m)))], axis=-1)
    return rng.uniform(-spread, spread, (n, 1, 2)) + np.cumsum(steps, 1)


def degenerate(pts, rows):
    """A copy of `pts` with point 1 equal to point 0 in `rows` (a
    duplicate support point)."""
    out = pts.copy()
    out[rows, 1] = out[rows, 0]
    return out


# ---- solve_small ---------------------------------------------------------------


@pytest.mark.parametrize("pivot", [False, True])
@pytest.mark.parametrize("n,m", [(4, None), (6, 2), (5, 3)])
def test_solve_small_matches_jax(pivot, n, m):
    """Well-conditioned systems, a system that needs a row swap (zero
    leading pivot, pivot=True only), and singular systems, whose
    non-finite solutions sit where JAX's do."""
    rng = np.random.default_rng(n * 10 + (m or 0) + pivot)
    A = rng.normal(size=(9, n, n)) + 3.0 * np.eye(n)
    b = rng.normal(size=(9, n) if m is None else (9, n, m))
    A[6] = 0.0                                   # singular
    A[7, :, 0] = 0.0                             # a zero column
    if pivot:
        A[8, 0, 0] = 0.0                         # needs a swap
    want = vmapped(lambda a, r: JSM.solve_small(a, r, pivot=pivot), A, b)
    got = TSM.solve_small(t64(A), t64(b), pivot=pivot)
    close(got, want)
    assert not np.isfinite(np.asarray(want)[6]).all()
    rhs = b[:6, :, None] if m is None else b[:6]
    ref = np.linalg.solve(A[:6], rhs)
    np.testing.assert_allclose(got[:6].numpy(),
                               ref[..., 0] if m is None else ref, atol=1e-10)


def test_solve_small_never_raises_where_linalg_does():
    A = torch.zeros((2, 3, 3), dtype=torch.float64)
    b = torch.ones((2, 3), dtype=torch.float64)
    x = TSM.solve_small(A, b, pivot=True)
    assert not torch.isfinite(x).any()
    with pytest.raises(RuntimeError):
        torch.linalg.solve(A, b)


# ---- ops.spline ----------------------------------------------------------------


def test_chord_param_and_notaknot_moments_match_jax():
    for m in (4, 5, 6):
        pts = degenerate(points(8, m, m), [5])
        u_want = vmapped(JSP.chord_param, pts)
        u = TSP.chord_param(t64(pts))
        close(u, u_want)
        close(TSP.notaknot_moments(u, t64(pts)),
              vmapped(JSP.notaknot_moments, u_want, pts))


@pytest.mark.parametrize("fit", ["fit_masked", "fit_masked_banded"])
def test_masked_fits_match_jax(fit):
    """Valid counts 4, 5 and 6 side by side, padded rows of any finite
    value, and duplicate valid points (non-finite moments where JAX's
    are; a duplicate in the padding changes nothing)."""
    pts = points(18, 6, 3)
    m = np.array([4, 5, 6] * 6, dtype=np.int32)
    pts = degenerate(pts, [0, 1, 2])             # duplicate valid points
    pts[3, 5] = pts[3, 4]                        # duplicate padding (m 4)
    t_w, M_w = vmapped(getattr(JSP, fit), pts, m)
    t, M = getattr(TSP, fit)(t64(pts), torch.from_numpy(m))
    close(t, t_w)
    close(M, M_w)
    assert not np.isfinite(np.asarray(M_w)[:3]).all()
    assert np.isfinite(np.asarray(M_w)[3:]).all()


def test_spline_eval_and_positions_match_jax():
    """Queries on every interval, exactly on the sites (the strict
    inequality: t = 1 evaluates the last valid interval, never the
    padding) and per agent."""
    pts = points(12, 6, 5)
    m = np.array([4, 5, 6] * 4, dtype=np.int32)
    t_w, M_w = vmapped(JSP.fit_masked_banded, pts, m)
    t, M = TSP.fit_masked_banded(t64(pts), torch.from_numpy(m))
    q20 = jnp.linspace(0.0, 1.0, 20)
    grid = TSP.uniform_grid(20, torch.float64)
    close(grid, q20, rtol=0, atol=0)
    want = jax.vmap(lambda a, b, c: JSP.eval_positions(a, b, c, q20))(
        t_w, jnp.asarray(pts), M_w)
    close(TSP.eval_positions(t, t64(pts), M, grid), want)
    q = np.concatenate([np.asarray(t_w)[:, :2], np.ones((12, 1)),
                        np.random.default_rng(6).uniform(0, 1, (12, 3))], 1)
    want = jax.vmap(JSP.spline_eval)(t_w, jnp.asarray(pts), M_w,
                                     jnp.asarray(q))
    got = TSP.spline_eval(t, t64(pts), M, t64(q))
    for g, w in zip(got, want):
        close(g, w)
    assert np.isfinite(np.asarray(want[1])).all()


def test_fit_eval_parametric_matches_jax():
    pts = degenerate(points(6, 5, 8), [4])
    want = JSP.fit_eval_parametric_batch(jnp.asarray(pts))
    close(TSP.fit_eval_parametric(t64(pts)), want)


# ---- the spline destination force ---------------------------------------------


def spline_scene(n=16, seed=0, t_glob=150, hist=128):
    """(JAX state, JAX params) reaching every branch of the spline force:
    agents in their first step, arrived, with forward destinations (the
    not-last fit over 4, 5 and 6 points), on their last destination (the
    1 s lookback), and falling back to the straight line, both for a
    look-ahead past the spline's end (a stop destination just ahead) and
    for duplicate support points (a rider that has not moved); and an
    inactive degenerate agent, which must not take the fallback."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, :2] = rng.uniform(-30, 30, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(2, 6, n)
    st = jax_make_state(s0, dtype=np.float64, hist_len=hist)
    head = np.stack([np.cos(s0[:, 2]), np.sin(s0[:, 2])], 1)
    # the ring: a straight ride up to the current position
    back = np.arange(hist)[None, :, None] - hist
    ring = s0[:, None, :2] + 0.04 * back * head[:, None, :]
    ring = np.roll(ring, (t_glob + 1) % hist, axis=1)
    ring[:, t_glob % hist] = s0[:, :2]
    for a in range(n):
        k = a % 4                                # queue length 1..4
        d = np.arange(1, k + 2)[:, None] * 8.0
        xs = s0[a, 0] + d[:, 0] * head[a, 0] + rng.uniform(-2, 2, k + 1)
        ys = s0[a, 1] + d[:, 0] * head[a, 1] + rng.uniform(-2, 2, k + 1)
        st = JS.set_destinations(st, a, xs, ys, reset=True)
    i = rng.integers(1, 400, n).astype(np.int32)
    i[0] = 0                                     # first step
    znav = np.array(st.znav)
    dq = np.array(st.destqueue)
    dq[1, :, 2] = 1.0
    znav[1] = [False, False, True]               # arrived
    # rider 8 (one destination) on its last leg, a stop destination 0.3 m
    # ahead: the look-ahead runs past the spline's end
    dq[8, 0, :2] = s0[8, :2] + 0.3 * head[8]
    dq[8, 0, 2] = 1.0
    ring[3] = s0[3, :2]                          # has not moved: duplicates
    ring[4] = s0[4, :2]                          # the same, but inactive
    active = np.ones(n, bool)
    active[4] = False
    st = st.replace(
        i=jnp.asarray(i), znav=jnp.asarray(znav), destqueue=jnp.asarray(dq),
        dest=jnp.asarray(dq[np.arange(n), 0]), pos_hist=jnp.asarray(ring),
        t_glob=jnp.asarray(t_glob, jnp.int32), active=jnp.asarray(active))
    params = JP.as_population(JP.InvPendulumBicycleParams.create(), n)
    return st, params


def run_both(st, params, lookback="auto"):
    want = jax.jit(JE.dest_force_spline)(params, st)
    got = TE.dest_force_spline(convert.params_from_jax(params, DEV),
                               convert.state_from_jax(st, DEV),
                               lookback=lookback)
    return got, want


def assert_same_force(got, want):
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    for f in ("dest", "destpointer", "znav", "znavparams", "i_stopsignal",
              "d_stopsignal"):
        close(getattr(got[2], f), getattr(want[2], f))


@pytest.mark.parametrize("t_glob", [150, 40, 0])
def test_dest_force_spline_matches_jax(t_glob):
    """Every branch at once (`spline_scene`), with the clock past the
    ring's length, inside it (the lookback clipped at step 0 of the
    clock) and at 0."""
    st, params = spline_scene(t_glob=t_glob)
    got, want = run_both(st, params)
    assert_same_force(got, want)
    fx = np.asarray(want[0])
    # all finite but the inactive duplicate rider's, which the step's
    # freeze discards; the arrived rider gets no force
    assert np.isfinite(np.delete(fx, 4)).all() and abs(fx[1]) == 0.0


def test_dest_force_spline_reaches_every_branch():
    """The scene's riders take the branches they were built for, in
    the port's own intermediate values."""
    st, params = spline_scene()
    p = convert.params_from_jax(params, DEV)
    ts = convert.state_from_jax(st, DEV)
    fx, fy, new = TE.dest_force_spline(p, ts)
    is_last = (new.destpointer >= ts.nq - 1).numpy()
    assert is_last.any() and (~is_last).any()
    assert {int(k) for k in ts.nq[~is_last]} >= {2, 3, 4}
    # the straight-line fallback for riders 8 (look-ahead) and 3
    # (duplicates): their force points at their destination
    for a in (8, 3):
        to = new.dest[a, :2] - ts.s[a, :2]
        cross = float(fx[a] * to[1] - fy[a] * to[0])
        assert abs(cross) < 1e-9 and float(fx[a] * to[0] + fy[a] * to[1]) > 0
    # the inactive duplicate rider keeps a non-finite spline force
    assert not np.isfinite(fx[4].item())
    # step 0 pushes along the heading
    assert np.isclose(float(torch.atan2(fy[0], fx[0])), float(ts.s[0, 2]))


def test_dest_force_spline_per_agent_lookback():
    """t_s that differs between agents: the per-agent one-hot lookback of
    the ring, decided when the lookback is None."""
    st, params = spline_scene(t_glob=90)
    ts = np.full(st.n, 0.01)
    ts[::3] = 0.02
    params = params.replace(t_s=jnp.asarray(ts))
    assert TE.spline_lookback(convert.params_from_jax(params, DEV)) is None
    got, want = run_both(st, params, lookback=None)
    assert_same_force(got, want)
    got_auto, _ = run_both(st, params)
    close(got_auto[0], want[0])


def test_engine_decides_the_lookback_once():
    """The engine reads t_s when it is built and keeps the lookback
    (`dest_kw`, one of the attributes a capture froze); a short ring
    warns as the JAX package does."""
    from cyclistsocialforce_tpu_torch.models import MODELS

    p = TP.as_population(TP.InvPendulumBicycleParams.create(), 4, DEV)
    eng = TE.Engine.create(p, MODELS["twod"])
    assert eng.dest_kw == {"lookback": 100}
    assert "dest_kw" in TE.Engine._FROZEN_BY_A_CAPTURE
    assert TE.Engine.create(TP.BicycleParams.create(t_s=0.02),
                            MODELS["twod"]).dest_kw == {"lookback": 50}
    assert eng.with_params(p.replace(t_s=0.05)).dest_kw == {"lookback": 20}
    assert TE.Engine.create(p, MODELS["bicycle2d"]).dest_kw == {}
    st = TS.make_state(np.zeros((4, 5)), hist_len=8, dtype=torch.float64,
                       device=DEV)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        TE.dest_force_spline(p, st, lookback=100)
    assert any("hist_len=8" in str(w.message) for w in caught)


# ---- host-side set-up and the parameters ---------------------------------------


def test_spline_prototype_and_destinations_match_jax():
    x, y = [5.0, 10.0, 20.0, 24.0], [1.0, 4.0, 3.0, -2.0]
    close(np.stack(TT.generate_spline_prototype(x, y, 7)),
          np.stack(JT.generate_spline_prototype(x, y, 7)))
    with pytest.raises(ValueError, match="3 points"):
        TT.generate_spline_prototype(x[:2], y[:2])
    s0 = np.array([[0.0, 0, 0, 5, 0], [3.0, 3, 1, 4, 0]])
    jst = JS.set_spline_destinations(
        jax_make_state(s0, dtype=np.float64), 1, x, y, 6, stop=True)
    tst = TS.set_spline_destinations(
        TS.make_state(s0, dtype=torch.float64, device=DEV), 1, x, y, 6,
        stop=True)
    for f in ("destqueue", "nq", "dest", "destpointer"):
        close(getattr(tst, f), getattr(jst, f))


def test_invpendulum_params_match_jax():
    kw = dict(h=1.1, m=80.0, k_d0_r2=-500.0, v_max_riding=(-1.0, 6.5))
    jp, tp = (JP.InvPendulumBicycleParams.create(**kw),
              TP.InvPendulumBicycleParams.create(**kw))
    conv = convert.params_from_jax(jp, DEV)
    assert type(conv) is TP.InvPendulumBicycleParams
    for f in ("h", "m", "tau_1_squared", "k_d0_r2", "a_max", "v_max_riding",
              "delta_max_walk", "hfov", "g"):
        close(np.asarray(getattr(tp, f)), np.asarray(getattr(jp, f)))
        close(np.asarray(getattr(conv, f)), np.asarray(getattr(jp, f)))
    v = np.array([1.5, 3.0, 5.0, 7.0])
    for g, w in zip(tp.fullstate_feedback_gains(t64(v)),
                    jp.fullstate_feedback_gains(jnp.asarray(v))):
        close(g, w)
    for g, w in zip(tp.timevarying_combined_params(t64(v)),
                    jp.timevarying_combined_params(jnp.asarray(v))):
        close(g, w)
    close(np.asarray(tp.min_stable_speed_inner()),
          jp.min_stable_speed_inner())
    with pytest.raises(ValueError, match="k_d0_r2"):
        TP.InvPendulumBicycleParams.create(k_d0_r2=1.0)
    # the ZOH tables build (tests/test_torch_invpendulum.py holds them to
    # JAX's at their own sizes)
    lut = TP.InvPendulumBicycleParams.create(zoh_lut=64).ip_zoh_lut[0]
    want = np.asarray(JP.InvPendulumBicycleParams.create(
        zoh_lut=64).ip_zoh_lut[0])
    assert (np.abs(lut.numpy() - want).max(axis=1)
            <= 1e-10 * np.abs(want).max(axis=1)).all()
    poly = TP.InvPendulumBicycleParams.create(zoh_poly=8).ip_zoh_poly
    assert len(poly[0]) == 8 and len(poly[0][0]) == 180
    pop = TP.as_population(tp, 3, device=DEV)
    assert pop.h.shape == (3,) and pop.a_max.shape == (3, 2)
