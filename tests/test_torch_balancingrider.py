"""PyTorch port: the balancing-rider bicycle (`models.balancingrider`,
`BalancingRiderParams`) held to the JAX package at float64 and to the
reference's golden, in every deterministic gain mode.

On the CPU: `create` in each mode (exact placement, `gains_lut`,
`gains_poly`, `prop_lut`, `prop_poly`, fixed gains, fixed poles) against
JAX's (matrices, pole functions, tables and fits at 1e-12 relative), its
validation and what stays refused of the stochastic parts; `prepare` and one
step of each mode (shared and per-rider parameters, riders whose speed
does not change holding their cached gains) against the JAX step at
1e-12; the gains_poly evaluation against JAX's select form, and at the
band's top edge in float32; tests/test_parity_balancingrider.py's golden
at 1e-9 and every mode's 700-step run against JAX's at 1e-9 m; the LUT
and poly error bounds and the below-band clamps of tests/test_gains_lut.py
on the port; the explicit-gains mode; `as_population`,
`convert.params_from_jax` and the crowds of `scenarios`; a culled
256-rider run against JAX's culled engine; a `MixedEngine` of bicycle2d
and balancing riders against JAX's; the chunk behind the runner's static
buffers (tests/test_torch_graph.py) against the eager loop. On the card
(`cuda` marker): the graphed run against the eager loop bit for bit in
every mode, a chunk with every host synchronisation an error, and the
gains_poly step with TF32 allowed bit-equal to TF32 off. The JAX package
comes in through the `jx` fixture, so the card's tests also run where JAX
is not installed.
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
from cyclistsocialforce_tpu_torch.ops.piecewise import \
    eval_piecewise_poly  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BalancingRiderParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import (  # noqa: E402
    build_flagship_crowd, build_population)
from cyclistsocialforce_tpu_torch.state import make_state  # noqa: E402
from test_torch_graph import (MODES, DirectRunner, assert_same,  # noqa: E402
                              simulate_direct, snapshot)
from test_torch_twod import (ENCROACH_DESTS, ENCROACH_S0,  # noqa: E402
                             run_scenario_port)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = 1e-12
K, STEPS = 5, 12          # two chunks and a 2-step tail
FIXED_GAINS = [-13.14, 1.10, -6.69, -0.11, -11.38]
FIXED_POLES = [-3.0, -1 + 2j, -1 - 2j, -2 + 5j, -2 - 5j]
# the deterministic gain modes: create() keywords
GAIN_MODES = {"exact": {}, "gains_lut": {"gains_lut": 512},
              "gains_poly": {"gains_poly": 16}, "prop_lut": {"prop_lut": 512},
              "prop_poly": {"prop_poly": 16}, "fixed": {"gains": FIXED_GAINS},
              "poles": {"poles": FIXED_POLES}}
ENCROACH_V = [4.5, 5.0, 5.0]


@pytest.fixture
def jx():
    """The JAX package's modules and test helpers used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import parity_common

    from cyclistsocialforce_tpu import engine, make_state, mixed, params
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import prepare as jprepare
    from cyclistsocialforce_tpu.ops import piecewise
    from cyclistsocialforce_tpu.state import set_destinations

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, JE=engine, JP=params, JM=mixed, JPW=piecewise,
        make_state=make_state, MODELS=JMODELS, prepare=jprepare,
        set_destinations=set_destinations, pc=parity_common)


@functools.lru_cache(maxsize=None)
def port_params(mode):
    return BalancingRiderParams.create(**GAIN_MODES[mode])


def jax_params(jx, mode):
    return jx.JP.BalancingRiderParams.create(verbose=False, **GAIN_MODES[mode])


def assert_rel(got, want, tol=TOL):
    """|got - want| <= tol * max(1, max |want|)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# ---- create ------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(GAIN_MODES))
def test_create_matches_jax(jx, mode):
    """The matrices, pole functions or fixed gains, the tables (each row
    within 1e-12 of JAX's relative to the row, the same grid) and the fits
    (coefficients within 1e-12 of the largest, the same band) of
    `create(**mode)`; what a mode does not build is None in both."""
    got, want = port_params(mode), jax_params(jx, mode)
    for f in ("br_A0", "br_A1", "br_A2", "br_B", "br_B_roll", "br_pole_lin",
              "br_gains_fixed"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert isinstance(g, tuple)
            assert_rel(np.asarray(g), w)
    for f in ("br_gains_lut", "br_prop_lut"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            tab = g[0].numpy()
            assert g[0].dtype == torch.float64 and tab.shape == w[0].shape
            assert (g[1], g[2]) == (float(w[1]), float(w[2]))
            rel = (np.abs(tab - w[0]).max(axis=1)
                   / np.abs(w[0]).max(axis=1))
            assert rel.max() <= TOL and np.isfinite(tab).all()
    for f in ("br_gains_poly", "br_prop_poly"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert g[1:] == w[1:] and len(g[0]) == len(w[0])
            C, Cj = np.asarray(g[0]), np.asarray(w[0])
            assert np.abs(C - Cj).max() <= TOL * np.abs(Cj).max()
            assert all(isinstance(c, float) for c in g[0][0])
    for f in ("l", "l_1", "l_2", "g", "m", "v_max_riding", "t_s", "k_p_v"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-15)
    assert got.stochastic_control_behavior is False
    assert got.br_disturb is False


def test_create_validation():
    """tests/test_gains_lut.py's refusals: both propagator modes at once,
    and a fit band that v_max_riding leaves empty."""
    with pytest.raises(ValueError, match="alternative"):
        BalancingRiderParams.create(prop_lut=256, prop_poly=16)
    for kw in ({"gains_poly": 16}, {"prop_poly": 16}):
        with pytest.raises(ValueError, match="v_max_riding"):
            BalancingRiderParams.create(v_max_riding=(-1.0, 1.5), **kw)
    with pytest.raises(ValueError, match="p_dist_roll"):
        BalancingRiderParams.create(p_dist_roll=1.5)


def test_stochastic_parts_raise():
    """What stays refused of the stochastic parts, now ported
    (tests/test_torch_stochastic.py): the propagator modes with the
    stochastic control behavior raise JAX's ValueError; the stochastic
    parameters and the disturbances step and prepare; `replace` keeps
    `br_disturb` fresh, as the JAX package's does."""
    for kw in ({"prop_lut": 64}, {"prop_poly": 16}):
        with pytest.raises(ValueError, match="prop"):
            BalancingRiderParams.create(stochastic_control_behavior=True,
                                        **kw)
    p = port_params("gains_poly")
    st = prepare(MODELS["balancingrider"], p, stable_state())
    f = torch.ones(st.n, dtype=torch.float64)
    for kw in ({"stochastic_control_behavior": True},
               {"p_dist_steer": 0.1}):
        other = BalancingRiderParams.create(gains_poly=16, **kw)
        out = BR.step(other, prepare(MODELS["balancingrider"], other, st),
                      f, f)
        assert torch.isfinite(out.s).all()
    assert p.replace(p_dist_steer=0.1).br_disturb is True
    assert p.replace(p_dist_steer=0.1).replace(
        p_dist_steer=0.0).br_disturb is False


# ---- one step ----------------------------------------------------------------


def step_inputs(jx, n=24, seed=5):
    """A prepared JAX float64 balancing-rider state and forces: speeds
    0.3-9.5 m/s (below, inside and at the top of the fit band), random
    latents and cached gains; every third rider commanded its own speed
    (vd == v: the speed does not change, the gains hold)."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 8))
    s0[:, :2] = rng.uniform(-20, 20, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = np.linspace(0.3, 9.5, n)
    s0[:, 4:8] = rng.uniform(-0.2, 0.2, (n, 4))
    st = jx.make_state(s0, dtype=np.float64, hist_len=8,
                       model=jx.MODELS["balancingrider"])
    st = jx.prepare(jx.MODELS["balancingrider"],
                    jx.JP.BalancingRiderParams.create(verbose=False), st)
    dg = np.asarray(st.dyn_gains).copy()
    dg[:, :5] *= rng.uniform(0.5, 1.5, (n, 5))
    st = st.replace(dyn_gains=jx.jnp.asarray(dg))
    fx, fy = rng.normal(0, 4, n), rng.normal(0, 4, n)
    hold = np.arange(n) % 3 == 0
    fx[hold], fy[hold] = s0[hold, 3], 0.0
    return st, fx, fy, hold


@pytest.mark.parametrize("per_rider", [False, True])
@pytest.mark.parametrize("mode", sorted(GAIN_MODES))
def test_one_step_matches_jax(jx, mode, per_rider):
    """One `step` of every rider in each gain mode against the JAX step at
    1e-12 (relative to each field's largest value: the gains below 1 m/s
    reach 1e5); riders whose speed did not change keep their cached gains
    in the modes that hold them."""
    st, fx, fy, hold = step_inputs(jx)
    jp, tp = jax_params(jx, mode), port_params(mode)
    if per_rider:
        jp = jx.JP.as_population(jp, st.n)
        tp = as_population(tp, st.n, DEV)
    want = jx.jax.jit(jx.MODELS["balancingrider"].step)(
        jp, st, jx.jnp.asarray(fx), jx.jnp.asarray(fy))
    tst = convert.state_from_jax(st, DEV)
    got = BR.step(tp, tst, torch.from_numpy(fx), torch.from_numpy(fy))
    for f in ("s", "dyn_x", "dyn_v", "dyn_gains"):
        assert_rel(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.s[hold, 3].numpy(),
                                  tst.s[hold, 3].numpy())
    if mode in ("exact", "gains_lut", "gains_poly", "poles"):
        np.testing.assert_array_equal(got.dyn_gains[hold].numpy(),
                                      tst.dyn_gains[hold].numpy())


@pytest.mark.parametrize("mode", ["exact", "gains_poly", "fixed"])
def test_prepare_matches_jax(jx, mode):
    """`prepare`: the frame flips and the initial gains, which are the
    exact placement at the initial speed in the poly and LUT modes too."""
    st, _, _, _ = step_inputs(jx)
    st = st.replace(dyn_gains=st.dyn_gains * 0.0, dyn_x=st.dyn_x * 0.0)
    want = jx.prepare(jx.MODELS["balancingrider"], jax_params(jx, mode), st)
    got = prepare(MODELS["balancingrider"], port_params(mode),
                  convert.state_from_jax(st, DEV))
    for f in ("dyn_x", "dyn_v", "dyn_gains"):
        assert_rel(getattr(got, f), getattr(want, f))
    if mode == "gains_poly":
        exact = prepare(MODELS["balancingrider"], port_params("exact"),
                        convert.state_from_jax(st, DEV))
        assert torch.equal(got.dyn_gains, exact.dyn_gains)


def test_gains_poly_is_the_select_form(jx):
    """The step's gains_poly evaluation (`eval_piecewise_poly`, 5 outputs)
    equals the JAX package's `"select"` form on the same fit in float64,
    across the band, below it and above it."""
    poly = port_params("gains_poly").br_gains_poly
    v = np.concatenate([np.linspace(0.0, 12.0, 997), [2.0, 10.0, 2.5]])
    got = torch.stack(eval_piecewise_poly(poly, torch.from_numpy(v), 5))
    want = np.stack([np.asarray(c) for c in jx.JPW.eval_piecewise_poly(
        poly, jx.jnp.asarray(v), 5, form="select")])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


def test_gains_poly_band_top_edge_in_float32(jx):
    """At the band's top edge (10 m/s) the float32 gains equal the float64
    ones within 1e-6 relative, at 16 and 64 segments. The JAX select form
    clamps x to S - 1e-6, which float32 rounds to S from 64 segments on:
    no segment matches and it falls back to segment 0's value, K(2 m/s)
    (ROADMAP Queue 3.9)."""
    for n_seg in (16, 64):
        poly = BalancingRiderParams.create(gains_poly=n_seg).br_gains_poly
        got = [torch.stack(eval_piecewise_poly(
            poly, torch.tensor([10.0], dtype=dt), 5)).double()
            for dt in (torch.float32, torch.float64)]
        np.testing.assert_allclose(got[0].numpy(), got[1].numpy(),
                                   rtol=1e-6)
        jax32 = np.stack([np.asarray(c, dtype=np.float64) for c in
                          jx.JPW.eval_piecewise_poly(
                              poly, jx.jnp.asarray([10.0], np.float32), 5,
                              form="select")])
        seg0 = np.array([[poly[0][0][6 * k]] for k in range(5)])
        if n_seg == 64:
            np.testing.assert_allclose(jax32, seg0, rtol=1e-6)
        else:
            np.testing.assert_allclose(jax32, got[1].numpy(), rtol=1e-6)


# ---- trajectories ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def port_run(mode, steps):
    return run_scenario_port("balancingrider", port_params(mode),
                             ENCROACH_S0, ENCROACH_DESTS, steps, ENCROACH_V)


# every mode's run against JAX's: 700 steps (the golden's) for the exact
# placement, 300 for the others
TRAJ_STEPS = {"exact": 700, "gains_lut": 300, "gains_poly": 300,
              "prop_lut": 300, "prop_poly": 300, "fixed": 300}


@pytest.mark.parametrize("mode", sorted(TRAJ_STEPS))
def test_trajectories_match_jax(jx, mode):
    """The encroachment scenario through the port and through the JAX
    package at float64 in each mode: every position within 1e-9 m, every
    state and force within 1e-9."""
    steps = TRAJ_STEPS[mode]
    want = jx.pc.run_scenario("balancingrider", jax_params(jx, mode),
                              ENCROACH_S0, ENCROACH_DESTS, steps,
                              v_desired=ENCROACH_V)
    got = port_run(mode, steps)
    pos = np.hypot(got[0][..., 0] - want[0][..., 0],
                   got[0][..., 1] - want[0][..., 1])
    assert pos.max() < 1e-9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    assert np.isfinite(got[0]).all()


def test_encroachment_balancingrider_golden(jx):
    """tests/test_parity_balancingrider.py's bar: the reference's golden
    at 1e-9 on position, force and speed."""
    golden = jx.pc.load_golden("encroachment_balancingrider.npz")
    jx.pc.assert_parity(golden, *port_run("exact", 700), 3, pos_tol=1e-9,
                        force_tol=1e-9, v_tol=1e-9)


def stable_state(n=64, seed=4, dtype=torch.float64):
    """tests/test_gains_lut.py's crowd: n riders in an 80 m square,
    headings within 0.3 rad of +x, 4-6 m/s, the destination 100 m
    ahead."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, 80, n)
    s0[:, 1] = rng.uniform(0, 80, n)
    s0[:, 2] = rng.uniform(-0.3, 0.3, n)
    s0[:, 3] = rng.uniform(4, 6, n)
    return with_dests(make_state(s0, dtype=dtype, device=DEV), 100.0)


def with_dests(st, ahead):
    """`st` with one destination `ahead` m in +x of every rider."""
    dst = torch.cat([st.s[:, :1] + ahead, st.s[:, 1:2],
                     torch.zeros_like(st.s[:, :1])], dim=1)
    dq = st.destqueue.clone()
    dq[:, 0, :] = dst
    return st.replace(dest=dst, destqueue=dq)


def dense_final(params, st, steps):
    pp = as_population(params, st.n, DEV)
    m = MODELS["balancingrider"]
    final, traj = TE.Engine.create(pp, m).simulate(prepare(m, pp, st),
                                                   steps)
    return final, traj


@pytest.mark.parametrize("mode", ["gains_lut", "gains_poly", "prop_lut",
                                  "prop_poly"])
def test_approximate_modes_track_exact(mode):
    """tests/test_gains_lut.py's end-to-end bar on the port: 64 riders at
    riding speeds, 200 steps, every approximate mode within 1e-3 m of the
    exact placement's positions (tables of 4,096 speeds, fits of 16
    segments)."""
    kw = {k: (4096 if "lut" in k else v) for k, v in GAIN_MODES[mode].items()}
    st = stable_state(seed={"gains_lut": 4, "gains_poly": 13}.get(mode, 11))
    exact, _ = dense_final(port_params("exact"), st, 200)
    approx, _ = dense_final(BalancingRiderParams.create(**kw), st, 200)
    assert (approx.s[:, :2] - exact.s[:, :2]).abs().max() < 1e-3


def test_lut_and_poly_error_bounds():
    """tests/test_gains_lut.py's bounds on the port's tables: the 4,096-
    speed gains table within 1e-5 relative of the exact gains on
    [2.5, 10] (the v = 0 row repaired), the 16-segment fit within 2e-4
    on its band, evaluated as the step evaluates them; every
    [P | Q | R | K] row of the propagator table rebuilt independently."""
    p = port_params("exact")
    c = BR.step_constants(p, torch.float64, DEV)["constants"]
    vs = np.linspace(2.5, 10.0, 311)
    K = BR._exact_gains(c, torch.from_numpy(vs)).numpy()
    tab, v0, dv = BalancingRiderParams.create(gains_lut=4096).br_gains_lut
    tab = tab.numpy()
    assert np.isfinite(tab).all()
    t = (vs - v0) / dv
    i0 = np.clip(np.floor(t).astype(int), 0, tab.shape[0] - 2)
    w = (t - i0)[:, None]
    K_lut = tab[i0] * (1 - w) + tab[i0 + 1] * w
    err = np.linalg.norm(K_lut - K, axis=1) / np.linalg.norm(K, axis=1)
    assert err.max() < 1e-5, err.max()

    poly = port_params("gains_poly").br_gains_poly
    lo, seg = poly[1], poly[2]
    vb = np.linspace(lo + 1e-9, lo + 16 * seg - 1e-9, 307)
    K = BR._exact_gains(c, torch.from_numpy(vb)).numpy()
    K_poly = torch.stack(eval_piecewise_poly(
        poly, torch.from_numpy(vb), 5), dim=1).numpy()
    rel = np.abs(K_poly - K) / np.maximum(np.abs(K), 1e-2)
    assert rel.max() < 2e-4, rel.max()

    tab, v0, dv = port_params("prop_lut").br_prop_lut
    tab = tab.numpy()
    A0, A1, A2 = (np.asarray(getattr(p, f)) for f in ("br_A0", "br_A1",
                                                      "br_A2"))
    B, B_roll = np.asarray(p.br_B), np.asarray(p.br_B_roll)
    h = p.t_s
    for g in (200, 350, 511):
        v = v0 + g * dv
        Acl = A0 + v * A1 + v * v * A2 - np.outer(B, tab[g, 35:40])
        M = np.eye(5) - (h / 2.0) * Acl
        np.testing.assert_allclose(
            tab[g, :25], np.linalg.solve(M, np.eye(5) + h / 2.0 * Acl)
            .reshape(25), rtol=1e-12)
        np.testing.assert_allclose(tab[g, 25:30], np.linalg.solve(M, h * B),
                                   rtol=1e-12)
        np.testing.assert_allclose(tab[g, 30:35],
                                   np.linalg.solve(M, h * B_roll),
                                   rtol=1e-12)


def test_below_band_clamps_stay_finite_and_stable():
    """tests/test_gains_lut.py's below-band tests on the port: gains_poly
    riders at 0.2-1.8 m/s stay finite over 50 steps; prop_poly riders at
    0.5-1.5 m/s over 300 steps stay finite with the roll under pi/3."""
    s0 = np.zeros((8, 5))
    s0[:, 3] = np.linspace(0.2, 1.8, 8)
    st = with_dests(make_state(s0, dtype=torch.float64, device=DEV), 0.0)
    dq = st.destqueue.clone()
    dq[:, 0, 0] = 50.0
    st = st.replace(destqueue=dq, dest=dq[:, 0, :].clone())
    final, _ = dense_final(port_params("gains_poly"), st, 50)
    assert torch.isfinite(final.s).all()

    rng = np.random.default_rng(3)
    s0 = np.zeros((16, 5))
    s0[:, 0] = rng.uniform(0, 40, 16)
    s0[:, 1] = rng.uniform(0, 40, 16)
    s0[:, 3] = rng.uniform(0.5, 1.5, 16)
    st = with_dests(make_state(s0, dtype=torch.float64, device=DEV), 60.0)
    _, traj = dense_final(port_params("prop_poly"), st, 300)
    assert torch.isfinite(traj).all()
    assert traj[:, :, 5].abs().max() < np.pi / 3


def test_explicit_gains_mode():
    """tests/test_parity_balancingrider.py's explicit-gains test on the
    port: no pole model, and the encroachment riders stay finite and
    upright over 200 steps."""
    p = port_params("fixed")
    assert p.br_pole_lin is None and p.br_gains_fixed == tuple(FIXED_GAINS)
    traj = port_run("fixed", 300)[0][:200]
    assert np.isfinite(traj).all()
    assert np.abs(traj[:, :, 5]).max() < np.pi / 3


# ---- parameters and populations ------------------------------------------------


def test_as_population_shares_the_model():
    """`as_population` keeps the matrices and fits (static tuples) and the
    tables (placed on the device) shared, and broadcasts the pole
    functions, the fixed gains and the scalars per rider."""
    lut = as_population(port_params("gains_lut"), 5, DEV)
    assert lut.br_A0 is port_params("gains_lut").br_A0
    assert torch.equal(lut.br_gains_lut[0],
                       port_params("gains_lut").br_gains_lut[0])
    assert tuple(lut.br_pole_lin.shape) == (5, 5, 2)
    assert lut.t_s.shape == (5,) and lut.a_max.shape == (5, 2)
    poly = as_population(port_params("gains_poly"), 5, DEV)
    assert poly.br_gains_poly is port_params("gains_poly").br_gains_poly
    fixed = as_population(port_params("fixed"), 5, DEV)
    assert tuple(fixed.br_gains_fixed.shape) == (5, 5)
    assert fixed.br_pole_lin is None and fixed.br_gains_lut is None
    card = torch.device("cuda")
    with pytest.raises(ValueError, match="br_gains_lut"):
        TE._check_params_on(port_params("gains_lut"), card)
    TE._check_params_on(port_params("gains_poly"), card)


@pytest.mark.parametrize("mode", sorted(GAIN_MODES))
def test_params_from_jax_carries_every_mode(jx, mode):
    """`convert.params_from_jax` of JAX params in each mode, shared and per
    rider: the class, the static tuples, the tables; the step on the
    converted params equals the step on the port's own."""
    jp = jax_params(jx, mode)
    st, fx, fy, _ = step_inputs(jx)
    tst = convert.state_from_jax(st, DEV)
    args = (torch.from_numpy(fx), torch.from_numpy(fy))
    for src, own in ((jp, port_params(mode)),
                     (jx.JP.as_population(jp, st.n),
                      as_population(port_params(mode), st.n, DEV))):
        conv = convert.params_from_jax(src, DEV)
        assert type(conv) is BalancingRiderParams
        assert conv.br_gains_poly is src.br_gains_poly
        assert isinstance(conv.br_A0, tuple)
        got = BR.step(conv, tst, *args)
        want = BR.step(own, tst, *args)
        for f in ("s", "dyn_x", "dyn_gains"):
            assert_rel(getattr(got, f), getattr(want, f))


def test_populations_draw_as_jax(jx):
    """`build_population(model="balancingrider")` draws
    `__graft_entry__._build(model_name="balancingrider")`'s crowd (bench.py's
    flagship row), sized for the model; `build_flagship_crowd` draws
    `_build_flagship`'s stable crowd."""
    from __graft_entry__ import _build, _build_flagship

    _, want = _build(300, np.float64, density=0.02, hist_len=8,
                     pad_to_block=128, model_name="balancingrider")
    got = build_population(300, 0.02, 8, 128, torch.float64, DEV,
                           model="balancingrider")
    for f in ("s", "dest", "destqueue", "nq", "active", "uid", "dyn_x",
              "dyn_gains", "zrid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.dyn_x.shape[1] == 7 and got.dyn_gains.shape[1] == 12
    _, want = _build_flagship(200)
    got = prepare(MODELS["balancingrider"], port_params("exact"),
                  build_flagship_crowd(200, dtype=torch.float64, device=DEV))
    for f in ("dest", "destqueue", "nq"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.s[:, :4].numpy(),
                                  np.asarray(want.s)[:, :4])
    assert_rel(got.dyn_gains, want.dyn_gains)


# ---- the culled path, MixedEngine and the chunk ------------------------------


def br_engine(params=None, rebuild_every=K, **kw):
    """bench.py:main_heavy's engine at a small size."""
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=rebuild_every, screen=False, backend="pallas")
    return TE.Engine.create(params or port_params("gains_poly"),
                            MODELS["balancingrider"],
                            neighbors=TE.NeighborConfig(**{**cfg, **kw}))


def crowd(n, params=None, device=DEV, dtype=torch.float32):
    st = build_flagship_crowd(n, 0.02, 8, 128, dtype, device)
    return prepare(MODELS["balancingrider"],
                   params or port_params("gains_poly"), st)


def test_culled_matches_jax(jx):
    """The flagship path at a small size: 256 stable riders at 0.02 /m^2,
    gains_poly, the culled stage through K1's plain version in float64,
    12 steps with rebuilds every 5, against JAX's culled engine (its XLA
    pair path): every field within 1e-9."""
    st = crowd(256, dtype=torch.float64)
    jp = jax_params(jx, "gains_poly")
    jst = jx.make_state(st.s[:, :5].numpy(), hist_len=8, dtype=np.float64,
                        model=jx.MODELS["balancingrider"])
    jst = jst.replace(dest=jx.jnp.asarray(st.dest.numpy()),
                      destqueue=jx.jnp.asarray(st.destqueue.numpy()))
    jst = jx.prepare(jx.MODELS["balancingrider"], jp, jst)
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=K, screen=False)
    jeng = jx.JE.Engine.create(jp, jx.MODELS["balancingrider"],
                               neighbors=jx.JE.NeighborConfig(
                                   backend="xla", **cfg))
    want, _ = jx.jax.jit(lambda e, s: e.simulate(s, STEPS, record=False))(
        jeng, jst)
    got, _ = br_engine().simulate(st, STEPS, record=False)
    for f in ("s", "dyn_x", "dyn_gains", "dest", "znav", "i"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)


def test_mixed_bicycle2d_balancingrider_matches_jax(jx):
    """A `MixedEngine` of 6 bicycle2d riders (their legacy field) and 6
    balancing riders (gains_poly, per rider), close enough to interact,
    150 steps on the dense stage: the port against JAX's `MixedEngine`,
    every position within 1e-9 m and every state within 1e-8; the groups
    repel each other."""
    rng = np.random.default_rng(14)
    n = 12
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, 25, n)
    s0[:, 1] = rng.uniform(0, 25, n)
    s0[:, 2] = rng.uniform(-0.2, 0.2, n)
    s0[:, 3] = rng.uniform(4.0, 5.5, n)
    jst = jx.make_state(s0, dtype=np.float64)
    for a in range(n):
        jst = jx.set_destinations(jst, a, (float(s0[a, 0]) + 40.0,),
                                  (float(s0[a, 1]),))
    groups = [("bicycle2d", jx.JP.as_population(
                   jx.JP.BicycleParams.create(), 6), 6),
              ("balancingrider", jx.JP.as_population(
                   jax_params(jx, "gains_poly"), 6), 6)]
    jeng = jx.JM.MixedEngine.create(groups)
    jst = jx.JM.prepare_groups(jeng, jst)
    _, want = jx.jax.jit(lambda s: jeng.simulate(s, 150))(jst)

    specs = convert.group_specs_from_jax(jeng, DEV)
    assert [m for m, _, _ in specs] == [MODELS["bicycle2d"],
                                        MODELS["balancingrider"]]
    eng = MixedEngine.create(specs)
    fresh = jx.make_state(s0, dtype=np.float64)
    st = prepare_groups(eng, convert.state_from_jax(fresh.replace(
        destqueue=jst.destqueue, dest=jst.dest, nq=jst.nq), DEV))
    _, traj = eng.simulate(st, 150)
    want = np.asarray(want)
    pos = np.hypot(*(traj.numpy() - want)[..., :2].transpose(2, 0, 1))
    assert pos.max() < 1e-9
    np.testing.assert_allclose(traj.numpy(), want, rtol=0, atol=1e-8)

    alone = MixedEngine.create(specs[1:])
    sub = prepare_groups(alone, convert.state_from_jax(
        jx.make_state(s0[6:], dtype=np.float64).replace(
            destqueue=jst.destqueue[6:], dest=jst.dest[6:], nq=jst.nq[6:]),
        DEV))
    _, solo = alone.simulate(sub, 150)
    assert (traj[:, 6:, :2] - solo[..., :2]).abs().max() > 1e-3


@pytest.mark.parametrize("mode", sorted(GAIN_MODES))
def test_direct_runner_equals_eager_loop(mode):
    """Each mode's chunk behind the runner's static buffers (the chunk run
    in place of a replay) equals the eager loop in every field and record,
    at 256 stable riders."""
    params = port_params(mode)
    eng = br_engine(params)
    st = crowd(256, params)
    want = eng.simulate(st, STEPS, graph=False, **MODES["states"])
    got = simulate_direct(eng, st, STEPS, "states")
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


def card_params(mode, device):
    """The mode's params with their tables on `device` (a capture copies
    nothing from the host)."""
    p = port_params(mode)
    upd = {f: (getattr(p, f)[0].to(device),) + getattr(p, f)[1:]
           for f in p.POPULATION_SHARED if getattr(p, f) is not None}
    return p.replace(**upd)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(GAIN_MODES))
@pytest.mark.parametrize("rec", ["none", "metrics_sorted", "states"])
def test_cuda_balancingrider_graph_equals_eager(cuda_device, mode, rec):
    """The graphed run equals the eager loop bit for bit in every gain
    mode; the capture records one K1 launch per step."""
    params = card_params(mode, cuda_device)
    eng = br_engine(params, rebuild_every=CARD_K)
    st = crowd(4096, params, cuda_device)
    assert not eng.neighbor_cache(st)[3].any()
    want = eng.simulate(st, CARD_STEPS, graph=False, **MODES[rec])
    PF.reset_launches()
    got = eng.simulate(st, CARD_STEPS, graph=True, **MODES[rec])
    torch.cuda.synchronize()
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert runner.captured == (CARD_K, 0, 0)
    assert torch.isfinite(got[0].s).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(GAIN_MODES))
def test_cuda_balancingrider_chunk_has_no_sync_point(cuda_device, mode):
    """One eager chunk on the card with every host synchronisation an
    error: the placement, the pivoted 5x5 solve, the table rows and the
    poly's segment selection included."""
    params = card_params(mode, cuda_device)
    eng = br_engine(params, rebuild_every=CARD_K)
    st = crowd(4096, params, cuda_device)
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
def test_cuda_gains_poly_step_ignores_tf32(cuda_device):
    """The gains_poly step with TF32 allowed for matrix products gives the
    bits of the step with it off (no product in the step that TF32 could
    round)."""
    params = port_params("gains_poly")
    st = crowd(4096, params, cuda_device)
    rng = np.random.default_rng(2)
    fx, fy = (torch.as_tensor(rng.normal(3, 2, st.n), dtype=torch.float32,
                              device=cuda_device) for _ in range(2))
    flags = torch.backends.cuda.matmul.allow_tf32
    out = {}
    for allow in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            out[allow] = BR.step(params, st, fx, fy)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flags
    for f in ("s", "dyn_x", "dyn_gains"):
        assert torch.equal(getattr(out[True], f), getattr(out[False], f)), f
