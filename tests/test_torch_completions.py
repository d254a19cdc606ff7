"""PyTorch port: the small completions of what is ported, each held to the
JAX function on the same numpy inputs at float64 (rtol = atol = 1e-12, or
exactly for integer and boolean results): the chunked neighbor-table
build and the JAX keywords of `NeighborConfig`, `state.stop`/`go`, the
angle helpers, `utils.structures`, the psi-form wrappers of `ops.forces`
and `CarParams`."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu import engine as JE  # noqa: E402
from cyclistsocialforce_tpu import make_state as jax_make_state  # noqa: E402
from cyclistsocialforce_tpu import params as JP  # noqa: E402
from cyclistsocialforce_tpu import state as JS  # noqa: E402
from cyclistsocialforce_tpu.ops import forces as JF  # noqa: E402
from cyclistsocialforce_tpu.ops import neighbors as JNB  # noqa: E402
from cyclistsocialforce_tpu.utils import angles as JA  # noqa: E402
from cyclistsocialforce_tpu.utils import structures as JSt  # noqa: E402
from cyclistsocialforce_tpu_torch import Engine, NeighborConfig  # noqa: E402
from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import params as TP  # noqa: E402
from cyclistsocialforce_tpu_torch import state as TS  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import forces as TF  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import neighbors as TNB  # noqa: E402
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402
from cyclistsocialforce_tpu_torch.utils import angles as TA  # noqa: E402
from cyclistsocialforce_tpu_torch.utils import structures as TSt  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = dict(rtol=1e-12, atol=1e-12)


def close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **(tol or TOL))


# ---- the chunked table build and NeighborConfig's JAX keywords -------------


@pytest.mark.parametrize("chunk", [1, 5, 8, 24, 100])
@pytest.mark.parametrize("block_src,kb", [(64, 19), (128, 3)])
def test_chunked_table_equals_dense_and_jax(chunk, block_src, kb):
    """The table built in receiver-row chunks (a chunk that divides the 24
    rows, one that does not, one row at a time, one above the row count)
    equals the dense build in every valid entry, and JAX's chunked build;
    kb = 3 overflows."""
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-190.0, 190.0, (2, 1024 * 3))
    args = (54.0, 128, kb)
    dense = TNB.build(torch.from_numpy(x), torch.from_numpy(y), *args,
                      block_src=block_src)
    got = TNB.build(torch.from_numpy(x), torch.from_numpy(y), *args,
                    block_src=block_src, table_chunk=chunk)
    want = JNB.build(jnp.asarray(x), jnp.asarray(y), *args,
                     block_src=block_src, table_chunk=chunk)
    assert bool(dense[3].any()) == (kb == 3)
    for i in (0, 2, 3):                       # perm, valid, overflow
        assert torch.equal(got[i], dense[i])
        close(got[i], want[i])
    assert got[1].dtype == torch.int32
    valid = dense[2]
    assert torch.equal(got[1][valid], dense[1][valid])
    assert (got[1][~valid] == 0).all()
    jn, jv = np.asarray(want[1]), np.asarray(want[2])
    for row in range(valid.shape[0]):         # ties at d2 = 0: sets per row
        assert set(got[1][row][valid[row]].tolist()) == set(
            jn[row][jv[row]].tolist())


def test_jax_style_neighbor_config_constructs_and_changes_no_force():
    """A configuration written for the JAX package: `rebuild_mode` and
    `row_segments` are stored and change nothing, `table_chunk` builds
    the same table in chunks; bad values raise as there."""
    kw = dict(cutoff=50.0, block=128, block_src=64, kb=19, rebuild_every=5)
    jcfg = JE.NeighborConfig(rebuild_mode="flat", row_segments=2,
                             table_chunk=4, backend="xla", **kw)
    cfg = NeighborConfig(rebuild_mode="flat", row_segments=2, table_chunk=4,
                         **kw)
    assert (cfg.rebuild_mode, cfg.row_segments, cfg.table_chunk) == (
        jcfg.rebuild_mode, jcfg.row_segments, jcfg.table_chunk)
    assert NeighborConfig(**kw).table_chunk == 0
    st = build_population(1000, 0.02, 8, 128, torch.float64, DEV)

    def engine(c):
        return Engine.create(TP.BicycleParams.create(), MODELS["bicycle2d"],
                             rep_force="twod", neighbors=c)

    want = engine(NeighborConfig(**kw)).repulsive_sum_neighbors(st)
    got = engine(cfg).repulsive_sum_neighbors(st)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[0].abs().max() > 1.0
    fin_w, _ = engine(NeighborConfig(**kw)).simulate(st, 7, record=False)
    fin_g, _ = engine(cfg).simulate(st, 7, record=False)
    assert torch.equal(fin_g.s, fin_w.s)
    for bad in (dict(rebuild_mode="nested"), dict(row_segments=0)):
        with pytest.raises(ValueError):
            JE.NeighborConfig(**bad)
        with pytest.raises(ValueError, match=next(iter(bad))):
            NeighborConfig(**bad)


# ---- state.stop / state.go ---------------------------------------------------


def maneuver_states():
    rng = np.random.default_rng(12)
    s0 = np.zeros((4, 5))
    s0[:, :2] = rng.uniform(-20, 20, (4, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, 4)
    s0[:, 3] = [0.0, 2.5, 5.0, 7.5]
    jst = jax_make_state(s0, dtype=jnp.float64, hist_len=8, queue_size=6)
    for a in range(4):
        jst = JS.set_destinations(jst, a, rng.uniform(-50, 50, 3),
                                  rng.uniform(-50, 50, 3))
    jst = jst.replace(destpointer=jnp.asarray([0, 1, 2, 3], jnp.int32))
    return jst, convert.state_from_jax(jst, DEV)


@pytest.mark.parametrize("kw", [
    dict(stoptype=0), dict(stoptype=1, a_brake=-10.0),
    dict(stoptype=1, a_brake=-4.0), dict(stoptype=2, stopdest=(3.5, -7.25))])
def test_stop_matches_jax(kw):
    jst, tst = maneuver_states()
    for agent in range(4):
        want = JS.stop(jst, agent, **kw)
        got = TS.stop(tst, agent, **kw)
        for f in ("dest", "destpointer", "destqueue", "nq", "s"):
            close(getattr(got, f), getattr(want, f))
        assert got.dest[agent, 2] == 1.0
        assert torch.equal(tst.dest, convert.state_from_jax(jst, DEV).dest)


@pytest.mark.parametrize("gotype", [0, 1])
def test_go_matches_jax_and_resumes_after_stop(gotype):
    jst, tst = maneuver_states()
    for agent in range(4):
        jstop = JS.stop(jst, agent, stoptype=2, stopdest=(1.0, 2.0))
        tstop = TS.stop(tst, agent, stoptype=2, stopdest=(1.0, 2.0))
        want = JS.go(jstop, agent, gotype=gotype)
        got = TS.go(tstop, agent, gotype=gotype)
        for f in ("dest", "destpointer"):
            close(getattr(got, f), getattr(want, f))
        assert got.dest[agent, 2] == 0.0


def test_stop_and_go_reject_unknown_types():
    _, tst = maneuver_states()
    with pytest.raises(ValueError, match="Stop type"):
        TS.stop(tst, 0, stoptype=3)
    with pytest.raises(ValueError, match="a_brake"):
        TS.stop(tst, 0, stoptype=1)
    with pytest.raises(ValueError, match="Go type"):
        TS.go(tst, 0, gotype=2)


# ---- utils.angles ------------------------------------------------------------


def test_angle_helpers_match_jax():
    rng = np.random.default_rng(3)
    th = np.concatenate([rng.uniform(-np.pi, np.pi, 200),
                         [0.0, -0.0, np.pi, -np.pi, 1e-300, -1e-300]])
    deg = np.concatenate([rng.uniform(-720, 720, 200),
                          [0.0, 90.0, 180.0, 270.0, 360.0, -90.0]])
    x, y = rng.normal(size=(2, 200)) * 10
    x[:3], y[:3] = [1.0, -1.0, 0.0], [0.0, 0.0, -2.0]
    rho = rng.uniform(0, 30, 206)
    t = torch.from_numpy
    close(TA.expand_angle(t(th)), JA.expand_angle(jnp.asarray(th)))
    for g, w in zip(TA.cart2polar(t(x), t(y)),
                    JA.cart2polar(jnp.asarray(x), jnp.asarray(y))):
        close(g, w)
    for g, w in zip(TA.polar2cart(t(rho), t(th)),
                    JA.polar2cart(jnp.asarray(rho), jnp.asarray(th))):
        close(g, w)
    close(TA.to_deg(t(th)), JA.to_deg(jnp.asarray(th)))
    close(TA.to_rad(t(deg)), JA.to_rad(jnp.asarray(deg)))
    close(TA.angle_sumo_to_sfm(t(deg)), JA.angle_sumo_to_sfm(jnp.asarray(deg)))
    close(TA.angle_sfm_to_sumo(t(th)), JA.angle_sfm_to_sumo(jnp.asarray(th)))
    rho0, phi0 = TA.cart2polar(torch.zeros(1, dtype=torch.float64),
                               torch.zeros(1, dtype=torch.float64))
    assert rho0 == 0 and torch.isnan(phi0)          # as the reference
    assert sorted(TA.__all__) == sorted(JA.__all__)


# ---- utils.structures --------------------------------------------------------


def test_diffeq_matches_jax_and_lfilter():
    from scipy.signal import lfilter

    a = np.array([1.0, -1.5, 0.7])
    b = np.array([0.1, 0.2, 0.05])
    u = np.sin(np.linspace(0, 6, 40))
    jst = JSt.diffeq_init(a, b, y0=[0.3, -0.1], u0=[0.2, 0.4])
    tst = TSt.diffeq_init(a, b, y0=[0.3, -0.1], u0=[0.2, 0.4], device=DEV)
    for g, w in zip(tst, jst):
        close(g, w)
    for uk in u:
        jst, jy = JSt.diffeq_step(jst, uk, th=0.9)
        tst, ty = TSt.diffeq_step(tst, uk, th=0.9)
        close(ty, jy)
    for g, w in zip(tst, jst):
        close(g, w)
    st = TSt.diffeq_init(a, b, device=DEV)
    ys = []
    for uk in u:
        st, yk = TSt.diffeq_step(st, uk)
        ys.append(float(yk))
    np.testing.assert_allclose(ys, lfilter(b, a, u), atol=1e-12)
    st, y = TSt.diffeq_step(TSt.diffeq_init([1.0, 0.0], [10.0], device=DEV),
                            1.0, th=2.0)
    assert float(y) == 2.0


def test_complex_angles_match_jax():
    rng = np.random.default_rng(6)
    th = rng.uniform(-np.pi, np.pi, 64)
    deg = rng.uniform(-360, 360, 64)
    z1 = TSt.angle_from_euler(th, device=DEV)
    z2 = TSt.angle_from_euler(deg, deg=True, device=DEV)
    j1, j2 = JSt.angle_from_euler(th), JSt.angle_from_euler(deg, deg=True)
    assert z1.dtype == torch.complex128
    close(torch.view_as_real(z1), np.stack([j1.real, j1.imag], -1))
    close(torch.view_as_real(z2), np.stack([j2.real, j2.imag], -1))
    close(TSt.angle_to_euler(z1), JSt.angle_to_euler(j1))
    close(TSt.angle_to_euler(z2, deg=True), JSt.angle_to_euler(j2, deg=True),
          rtol=1e-12, atol=1e-10)
    comp, jcomp = TSt.angle_add(z1, z2), JSt.angle_add(j1, j2)
    close(TSt.angle_to_euler(comp), JSt.angle_to_euler(jcomp))
    close(TSt.angle_difference_complex(z1, z2),
          JSt.angle_difference_complex(j1, j2))
    d = TSt.angle_difference_complex(
        TSt.angle_from_euler(3.0, device=DEV),
        TSt.angle_from_euler(-3.0, device=DEV))
    np.testing.assert_allclose(float(d), 2 * np.pi - 6.0, atol=1e-12)
    twice = TSt.angle_from_euler(170.0, deg=True, device=DEV)
    np.testing.assert_allclose(
        float(TSt.angle_to_euler(TSt.angle_add(twice, twice), deg=True)),
        -20.0, atol=1e-9)


def test_fifo_matches_jax():
    rng = np.random.default_rng(8)
    init = rng.normal(size=(3, 2))
    jst, tst = JSt.fifo_init(init), TSt.fifo_init(init, device=DEV)
    for _ in range(7):
        v = rng.normal(size=2)
        jst, jout = JSt.fifo_next(jst, v)
        tst, tout = TSt.fifo_next(tst, v)
        close(tout, jout)
        close(tst[0], jst[0])
        assert int(tst[1]) == int(jst[1])
    st = TSt.fifo_init([1.0, 2.0, 3.0], device=DEV)
    outs = []
    for v in (4.0, 5.0, 6.0, 7.0):
        st, out = TSt.fifo_next(st, v)
        outs.append(float(out))
    assert outs == [1.0, 2.0, 3.0, 4.0]


def test_validate_boolean_indicators_matches_jax():
    good = ([True, False, True], [0, 2], np.array([1]))
    for sel in good:
        np.testing.assert_array_equal(
            TSt.validate_boolean_indicators(sel, "sel", "X", 3),
            JSt.validate_boolean_indicators(sel, "sel", "X", 3))
    for sel in ([True, False], [0, 5], [0.5, 1.0], [], [[0, 1]]):
        with pytest.raises(ValueError):
            JSt.validate_boolean_indicators(sel, "sel", "X", 3)
        with pytest.raises(ValueError, match="sel"):
            TSt.validate_boolean_indicators(sel, "sel", "X", 3)


# ---- ops.forces: the psi-form wrappers ------------------------------------------


def pair_inputs(n=24, seed=10):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-15, 15, (2, n))
    x[1], y[1] = x[0], y[0]                         # a coincident pair
    psi = rng.uniform(-np.pi, np.pi, n)
    v = rng.uniform(-1.0, 9.0, n)                   # negative speeds too
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    return x, y, psi, v, dx, dy


def test_psi_form_force_wrappers_match_jax():
    x, y, psi, v, dx, dy = pair_inputs()
    t, j = torch.from_numpy, jnp.asarray
    p = JP.BicycleParams.create()
    field = [float(getattr(p, f)) for f in (
        "f_0", "e_0", "e_1", "sigma_0", "sigma_1", "sigma_2", "sigma_3")]
    want = JF.rep_force_twod(j(dx), j(dy), j(psi)[:, None], j(psi)[None, :],
                             *field)
    got = TF.rep_force_twod(t(dx), t(dy), t(psi)[:, None], t(psi)[None, :],
                            *field)
    for g, w in zip(got, want):
        close(g, w)
    leg = (float(p.v_max_riding[1]), float(p.p_0), float(p.p_decay))
    want = JF.rep_force_legacy(j(dx), j(dy), j(psi)[:, None], j(v)[:, None],
                               *leg)
    got = TF.rep_force_legacy(t(dx), t(dy), t(psi)[:, None], t(v)[:, None],
                              *leg)
    for g, w in zip(got, want):
        close(g, w)
    close(TF.potential_legacy(t(dx), t(dy), t(psi)[:, None], t(v)[:, None],
                              *leg),
          JF.potential_legacy(j(dx), j(dy), j(psi)[:, None], j(v)[:, None],
                              *leg))
    assert float(got[0][0, 1]) == 0.0               # the coincident pair


@pytest.mark.parametrize("p2r", [False, True])
def test_untracked_foes_and_sum_repulsive_match_jax(p2r):
    x, y, psi, v, dx, dy = pair_inputs()
    rng = np.random.default_rng(11)
    n = x.shape[0]
    t, j = torch.from_numpy, jnp.asarray
    active = rng.uniform(size=n) < 0.8
    hfov = rng.uniform(1.0, 2 * np.pi, n)
    for h_t, h_j, act_t, act_j in (
            (2.0, 2.0, None, None),
            (t(hfov), j(hfov), t(active), j(active))):
        want = JF.untracked_foes(j(x), j(y), j(psi), h_j, act_j,
                                 priority_p2r=p2r)
        got = TF.untracked_foes(t(x), t(y), t(psi), h_t, act_t,
                                priority_p2r=p2r)
        assert got.dtype == torch.bool
        close(got, want)
        assert 0 < int(got.sum()) < n * n
    fpx, fpy = rng.normal(size=(2, n, n)) * 3
    fdx, fdy = rng.normal(size=(2, n))
    fdx[:4] *= 20                                   # clamp on both sides
    want = JF.sum_repulsive(j(fpx), j(fpy), ~want, j(fdx), j(fdy))
    got = TF.sum_repulsive(t(fpx), t(fpy), ~got, t(fdx), t(fdy))
    for g, w in zip(got, want):
        close(g, w)


# ---- params.CarParams --------------------------------------------------------


def test_car_params_match_jax_and_convert():
    jp = JP.CarParams.create(length=4.6, f_0=3.0)
    tp = TP.CarParams.create(length=4.6, f_0=3.0)
    conv = convert.params_from_jax(jp, DEV)
    assert type(conv) is TP.CarParams and conv == tp
    assert (tp.length, tp.width, tp.f_0) == (4.6, 2.0, 3.0)
    assert tp.hfov == TP.VehicleParams.create().hfov     # the vehicle's
    for f in ("length", "width", "hfov", "f_0", "sigma_3", "t_s"):
        assert getattr(tp, f) == float(getattr(jp, f)), f
    pop = convert.params_from_jax(JP.as_population(jp, 5), DEV)
    close(pop.length, np.full(5, 4.6))
    assert TP.as_population(tp, 5, device=DEV).width.shape == (5,)
    with pytest.raises(ValueError):
        TP.CarParams.create(f_0=-1.0)
