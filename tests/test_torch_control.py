"""PyTorch port: the control layer the invpendulum and planar models stand
on, held to the JAX package at float64 on the CPU.

`ops.smallmat` (`expm_small`, `matmul_small`, `matvec_small`) against the
JAX package's `expm_small` and `jax.scipy.linalg.expm` on the
inverted-pendulum ZOH matrices and on random matrices across the squaring
range, and in float32 against float64; `ops.control` (`poly_from_roots`,
`ackermann`, `discretize_foh`, `discretize_zoh`, `matrix_power`,
`dc_gain`, `charpoly_from_pole_features`, `ackermann_basis`,
`place_siso`) against the JAX functions and the analytic cases of
tests/test_control_oracles.py; `ops.piecewise` (the fit, the
`"matmul"` evaluation form, the band's top edge) against the JAX
functions. Inputs come from a
numpy seed and go through both packages. On the card (`cuda` marker): the
`"matmul"` form with TF32 allowed by the caller, bit for bit the CPU's.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch.ops import control as TC  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import piecewise as TPW  # noqa: E402
from cyclistsocialforce_tpu_torch.ops.smallmat import (  # noqa: E402
    expm_small, matmul_small, matvec_small)

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture
def jx():
    """The JAX package's control layer used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    from cyclistsocialforce_tpu.models import invpendulum as JIP
    from cyclistsocialforce_tpu.ops import control as JC
    from cyclistsocialforce_tpu.ops import piecewise as JPW
    from cyclistsocialforce_tpu.ops import smallmat as JS
    from cyclistsocialforce_tpu.params import InvPendulumBicycleParams

    return types.SimpleNamespace(jax=jax, jnp=jnp, jsl=jsl, JC=JC, JS=JS,
                                 JPW=JPW, JIP=JIP,
                                 JI=InvPendulumBicycleParams)


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def assert_rel(got, want, tol=TOL):
    """|got - want| <= tol * max(1, max |want|), elementwise."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def zoh_matrices(jx, vs):
    """tests/test_smallmat.py's 6x6 ZOH matrices of the inverted-pendulum
    closed loop at speeds `vs`, built by the JAX package."""
    p = jx.JI.create()
    K_x, K_u = p.fullstate_feedback_gains(jx.jnp.asarray(vs))
    pb = {f: jx.jnp.asarray(getattr(p, f)) for f in
          ("l", "l_2", "g", "tau_1_squared", "c_steer", "i_steer_vertvert")}

    def aug_one(v, kx, ku):
        A, B = jx.JIP.openloop_matrices(pb, v)
        Acl = A - B[:, None] * kx[None, :]
        aug = jx.jnp.zeros((6, 6), dtype=v.dtype)
        return aug.at[:5, :5].set(Acl * 0.01).at[:5, 5].set(ku * B * 0.01)

    return np.asarray(jx.jax.vmap(aug_one)(jx.jnp.asarray(vs), K_x, K_u))


# ---- ops.smallmat ------------------------------------------------------------


def test_expm_small_on_zoh_matrices_matches_jax(jx):
    """The production shape: the ZOH matrices across the speed range, one
    batched call, against the JAX `expm_small` (vmapped, 1e-12) and
    `jsl.expm` (at tests/test_smallmat.py's 1e-9 relative, 1e-11
    absolute: entries reach 1.4e4 at 0.5 m/s)."""
    augs = zoh_matrices(jx, np.linspace(0.5, 10.0, 40))
    got = expm_small(t64(augs))
    assert_rel(got, jx.jax.vmap(jx.JS.expm_small)(jx.jnp.asarray(augs)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jx.jax.vmap(jx.jsl.expm)(
            jx.jnp.asarray(augs))), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("kind,scale", [
    ("normal", 0.01), ("normal", 0.5), ("normal", 5.0), ("normal", 50.0),
    ("skew", 10.0), ("skew", 100.0), ("skew", 1000.0)])
def test_expm_small_across_the_squaring_range_matches_jax(jx, kind, scale):
    """Random 6x6 matrices whose 1-norms take 0 to 11 squarings: normal
    ones, and skew-symmetric ones (a bounded exponential at any norm).
    Each matrix of the batch takes its own count."""
    rng = np.random.default_rng(int(scale * 10) + len(kind))
    M = rng.normal(size=(16, 6, 6))
    A = (M - np.swapaxes(M, 1, 2) if kind == "skew" else M) * scale
    got = expm_small(t64(A))
    want = jx.jax.vmap(jx.JS.expm_small)(jx.jnp.asarray(A))
    for g, w in zip(got, np.asarray(want)):
        assert_rel(g, w)


@pytest.mark.parametrize("scale", [0.05, 0.2, 0.5, 2.0, 5.0])
def test_expm_small_float32_against_float64(jx, scale):
    """The float32 form (the card's dtype) against the float64 `jsl.expm`
    cast down, at the JAX test's bar (tests/test_smallmat.py: 5e-6
    relative): the norm-adaptive count takes no squaring for small
    norms."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(8, 6, 6)) * scale
    ref = np.asarray(jx.jax.vmap(jx.jsl.expm)(jx.jnp.asarray(A)))
    got = expm_small(torch.from_numpy(A.astype(np.float32))).numpy()
    for g, w in zip(got, ref.astype(np.float32)):
        assert np.abs(g - w).max() / max(1.0, np.abs(w).max()) < 5e-6


def test_small_products_match_jax(jx):
    rng = np.random.default_rng(2)
    A, B = rng.normal(size=(7, 5, 4)), rng.normal(size=(7, 4, 3))
    x = rng.normal(size=(7, 4))
    assert_rel(matmul_small(t64(A), t64(B)),
               jx.jax.vmap(jx.JS.matmul_small)(A, B))
    assert_rel(matvec_small(t64(A), t64(x)),
               jx.jax.vmap(jx.JS.matvec_small)(A, x))


# ---- ops.control -------------------------------------------------------------


def controllable_systems(n, batch, seed):
    """Random single-input systems (A [batch, n, n], B [batch, n]) and
    random stable real pole sets, as monic coefficients [batch, n + 1]."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(batch, n, n))
    B = rng.normal(size=(batch, n))
    poles = -rng.uniform(0.5, 3.0, size=(batch, n))
    coeffs = np.stack([np.poly(p) for p in poles])
    return A, B, poles, coeffs


@pytest.mark.parametrize("n", [2, 3, 5])
def test_ackermann_and_poly_from_roots_match_jax(jx, n):
    A, B, poles, coeffs = controllable_systems(n, 6, n)
    got_c = TC.poly_from_roots(t64(poles))
    assert_rel(got_c, jx.jax.vmap(jx.JC.poly_from_roots)(poles))
    assert_rel(got_c, coeffs)
    got = TC.ackermann(t64(A), t64(B), t64(coeffs))
    assert_rel(got, jx.jax.vmap(jx.JC.ackermann)(A, B, coeffs))
    # the placed closed loop has the desired poles
    Acl = A - B[:, :, None] * got.numpy()[:, None, :]
    for a, p in zip(Acl, poles):
        np.testing.assert_allclose(np.sort(np.linalg.eigvals(a).real),
                                   np.sort(p), atol=1e-8)


def test_poly_from_roots_complex_pair():
    """A conjugate pair gives a real monic quadratic (the planar bicycle's
    poles)."""
    p = -1.0141284591434665 + 1.226826644413086j
    c = TC.poly_from_roots(torch.tensor([p, p.conjugate()],
                                        dtype=torch.complex128))
    np.testing.assert_allclose(c.real.numpy(),
                               [1.0, -2 * p.real, abs(p) ** 2], atol=TOL)
    np.testing.assert_allclose(c.imag.numpy(), 0.0, atol=TOL)


@pytest.mark.parametrize("n,m", [(2, 1), (3, 2), (5, 1)])
def test_discretizations_match_jax(jx, n, m):
    """FOH (Ad, P, Q) and ZOH (Ad, Bd), batched, with a per-system dt."""
    rng = np.random.default_rng(10 * n + m)
    A = rng.normal(size=(4, n, n))
    B = rng.normal(size=(4, n, m)) if m > 1 else rng.normal(size=(4, n))
    dt = rng.uniform(0.005, 0.2, size=4)
    foh = TC.discretize_foh(t64(A), t64(B), t64(dt))
    zoh = TC.discretize_zoh(t64(A), t64(B), t64(dt))
    for i in range(4):
        want_f = jx.JC.discretize_foh(A[i], B[i], dt[i])
        want_z = jx.JC.discretize_zoh(A[i], B[i], dt[i])
        for g, w in zip(foh, want_f):
            assert_rel(g[i], w)
        for g, w in zip(zoh, want_z):
            assert_rel(g[i], w)
    # a number for dt equals the tensor of it
    for g, w in zip(TC.discretize_foh(t64(A[:1]), t64(B[:1]), float(dt[0])),
                    foh):
        assert_rel(g[0], w[0].numpy())


def test_matrix_power_and_dc_gain_match_jax(jx):
    rng = np.random.default_rng(4)
    A = rng.normal(size=(5, 3, 3)) * 0.4
    for k in (0, 1, 2, 7, 989):
        got = TC.matrix_power(t64(A), k)
        for g, a in zip(got, A):
            assert_rel(g, jx.JC.matrix_power(jx.jnp.asarray(a), k))
    Acl = A - 2.0 * np.eye(3)
    B, C = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    got = TC.dc_gain(t64(Acl), t64(B), t64(C))
    for g, a, b, c in zip(got, Acl, B, C):
        assert_rel(g, jx.JC.dc_gain(a, b, c[None, :]))


def test_control_analytic_cases():
    """tests/test_control_oracles.py's closed forms, on the port: pole
    placement on the double integrator, the first-order lag's DC gain, ZOH
    of a first-order lag, FOH of the double integrator and FOH against
    the convolution integral."""
    A = t64([[0.0, 1.0], [0.0, 0.0]])
    B = t64([0.0, 1.0])
    coeffs = TC.poly_from_roots(torch.tensor([-1 + 1j, -1 - 1j])).real
    np.testing.assert_allclose(TC.ackermann(A, B, coeffs).numpy(),
                               [2.0, 2.0], atol=TOL)

    a, b, c = 2.0, 3.0, 0.5
    g = TC.dc_gain(t64([[-a]]), t64([b]), t64([[c]]))
    np.testing.assert_allclose(float(g), c * b / a, atol=TOL)

    a, dt = 1.7, 0.05
    Ad, Bd = TC.discretize_zoh(t64([[-a]]), t64([1.0]), dt)
    np.testing.assert_allclose(float(Ad[0, 0]), np.exp(-a * dt), atol=TOL)
    np.testing.assert_allclose(float(Bd[0, 0]), (1 - np.exp(-a * dt)) / a,
                               atol=TOL)

    dt = 0.1
    Ad, P, Q = TC.discretize_foh(A, B, dt)
    u0, u1 = 3.0, 5.0
    x1 = (Ad.numpy() @ [1.0, -2.0] + P.numpy()[:, 0] * u0
          + Q.numpy()[:, 0] * (u1 - u0) / dt)
    pos = 1.0 + dt * (-2.0) + dt**2 * u0 / 2 + dt**2 * (u1 - u0) / 6
    vel = -2.0 + dt * u0 + dt * (u1 - u0) / 2
    np.testing.assert_allclose(x1, [pos, vel], atol=TOL)

    a, dt = 0.8, 0.2
    Ad, P, Q = TC.discretize_foh(t64([[-a]]), t64([1.0]), dt)
    x0, u0, u1 = 0.7, 1.0, -0.5
    x1 = (float(Ad[0, 0]) * x0 + float(P[0, 0]) * u0
          + float(Q[0, 0]) * (u1 - u0) / dt)
    s = np.linspace(0.0, dt, 200001)
    u = u0 + (u1 - u0) * s / dt
    integ = np.trapezoid(np.exp(-a * (dt - s)) * u, s)
    np.testing.assert_allclose(x1, np.exp(-a * dt) * x0 + integ, atol=1e-9)


def test_charpoly_from_pole_features_matches_jax(jx):
    """The characteristic polynomial of ImRe pole features, batched, for
    5, 3 and 1 features: against the JAX function's `jnp.convolve` form,
    and its roots are the encoded poles."""
    rng = np.random.default_rng(21)
    feats = rng.uniform(-6.0, 6.0, size=(9, 5))
    for m in (5, 3, 1):
        got = TC.charpoly_from_pole_features(t64(feats[:, :m]))
        assert tuple(got.shape) == (9, m + 1)
        for g, f in zip(got, feats[:, :m]):
            assert_rel(g, jx.JC.charpoly_from_pole_features(
                jx.jnp.asarray(f)))
    f = feats[0]
    poles = [f[0], f[1] + 1j * f[2], f[1] - 1j * f[2], f[3] + 1j * f[4],
             f[3] - 1j * f[4]]
    roots = np.roots(TC.charpoly_from_pole_features(t64(f)).numpy())
    np.testing.assert_allclose(np.sort_complex(roots),
                               np.sort_complex(np.array(poles)), atol=1e-9)


@pytest.mark.parametrize("n", [3, 5])
def test_ackermann_basis_matches_jax_and_identity(jx, n):
    """`ackermann_basis` against the JAX function, and
    tests/test_gains_lut.py's identity: `ackermann(A, B, c)` equals
    `c @ ackermann_basis(A, B)` for any monic polynomial (relative
    1e-10)."""
    A, B, _, _ = controllable_systems(n, 4, 30 + n)
    M = TC.ackermann_basis(t64(A), t64(B))
    assert tuple(M.shape) == (4, n + 1, n)
    for g, a, b in zip(M, A, B):
        assert_rel(g, jx.JC.ackermann_basis(jx.jnp.asarray(a),
                                            jx.jnp.asarray(b)))
    rng = np.random.default_rng(n)
    for _ in range(4):
        c = TC.charpoly_from_pole_features(
            t64(rng.uniform(0.5, 6.0, size=(4, 5))))[:, :n + 1]
        K = TC.ackermann(t64(A), t64(B), c)
        via = torch.sum(c[:, :, None] * M, dim=1)
        rel = (via - K).abs().amax() / K.abs().amax()
        assert float(rel) < 1e-10, float(rel)


def test_place_siso_matches_jax_and_the_oracles(jx):
    """`place_siso` against the JAX function on random controllable
    systems, the placed loop has the poles, and the closed forms of
    tests/test_control_oracles.py: the double integrator at -1 +- 1j
    gives K = [2, 2], the chain of three integrators at -1, -2, -3 gives
    [6, 11, 6]."""
    A, B, poles, _ = controllable_systems(4, 3, 8)
    got = TC.place_siso(t64(A), t64(B), poles)
    for g, a, b, p in zip(got, A, B, poles):
        assert_rel(g, jx.JC.place_siso(jx.jnp.asarray(a), jx.jnp.asarray(b),
                                       p))
        ev = np.linalg.eigvals(a - np.outer(b, g.numpy()))
        np.testing.assert_allclose(np.sort(ev.real), np.sort(p), atol=1e-8)
    K = TC.place_siso(t64([[0.0, 1.0], [0.0, 0.0]]), t64([0.0, 1.0]),
                      np.array([-1 + 1j, -1 - 1j]))
    np.testing.assert_allclose(K.numpy(), [2.0, 2.0], atol=TOL)
    K = TC.place_siso(t64([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                           [0.0, 0.0, 0.0]]), t64([[0.0], [0.0], [1.0]]),
                      np.array([-1.0, -2.0, -3.0]))
    np.testing.assert_allclose(K.numpy(), [6.0, 11.0, 6.0], atol=1e-10)


# ---- ops.piecewise -----------------------------------------------------------


def smooth_map(vs):
    """A smooth vector-valued schedule of speed (3 outputs)."""
    vs = np.asarray(vs)
    return np.stack([np.sin(vs), 1.0 / (1.0 + vs * vs), np.exp(-0.3 * vs)],
                    axis=1)


def test_fit_piecewise_poly_matches_jax(jx):
    """The numpy fit, the port's copy against the JAX package's: the same
    coefficients (1e-9), the same band and segment width."""
    got = TPW.fit_piecewise_poly(smooth_map, 1.0, 7.0, 8)
    want = jx.JPW.fit_piecewise_poly(smooth_map, 1.0, 7.0, 8)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=0, atol=1e-9)
    assert got[1:] == want[1:]
    assert TPW.fit_error(got, smooth_map) == pytest.approx(
        jx.JPW.fit_error(want, smooth_map), rel=1e-6)
    assert TPW.fit_error(got, smooth_map) < 1e-5
    with pytest.raises(ValueError, match="non-finite"):
        TPW.fit_piecewise_poly(lambda v: 1.0 / (v[:, None] - 2.0), 1.0,
                               3.0, 4)


def test_eval_piecewise_poly_matches_jax(jx):
    """The `"matmul"` form on the same coefficients, at speeds inside the
    band, below it and above it (both clamp to the band edges), with the
    coefficient matrix built in the call and passed in."""
    poly = TPW.fit_piecewise_poly(smooth_map, 1.0, 7.0, 8)
    vs = np.random.default_rng(1).uniform(0.0, 8.0, 300)
    want = jx.JPW.eval_piecewise_poly(poly, jx.jnp.asarray(vs), 3,
                                      form="matmul")
    coeffs = TPW.coeff_matrix(poly, torch.float64, "cpu")
    for got in (TPW.eval_piecewise_poly(poly, t64(vs), 3),
                TPW.eval_piecewise_poly(poly, t64(vs), 3, coeffs)):
        for g, w in zip(got, want):
            assert_rel(g, w)


def test_eval_piecewise_poly_band_top_edge_in_float32():
    """A float32 speed at the band's top edge takes the last segment at
    u = 1, for 32 and for 64 segments. (The JAX function's clamp to
    S - 1e-6 rounds to S in float32 at 64 segments and gives zeros
    there, ROADMAP Queue 3.)"""
    for n_seg in (32, 64):
        poly = TPW.fit_piecewise_poly(smooth_map, 1.0, 7.0, n_seg)
        v = torch.tensor([7.0, 7.5])
        got = torch.stack(TPW.eval_piecewise_poly(poly, v, 3), dim=1)
        want = torch.stack(TPW.eval_piecewise_poly(poly, v.double(), 3),
                           dim=1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
        np.testing.assert_allclose(want.numpy()[0], smooth_map([7.0])[0],
                                   rtol=1e-6)


def test_eval_piecewise_poly_matmul_is_the_one_hot_product():
    """The `"matmul"` form equals the JAX form's one-hot product in
    float32 bit for bit (an exact selection), and a NaN speed stays a NaN
    without an out-of-range index."""
    poly = TPW.fit_piecewise_poly(smooth_map, 1.0, 7.0, 16)
    v = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 7.5, 200).astype(np.float32))
    got = TPW.eval_piecewise_poly(poly, v, 3)
    C, lo, seg_dv = poly
    x = torch.clamp((v - lo) / seg_dv, 0.0, 16 - 1e-6)
    idx = torch.floor(x)
    onehot = (idx[None, :] == torch.arange(16.0)[:, None]).float()
    rows = torch.tensor(np.asarray(C).T, dtype=torch.float32) @ onehot
    u = x - idx
    for m, g in enumerate(got):
        acc = rows[6 * m + 5]
        for d in range(4, -1, -1):
            acc = acc * u + rows[6 * m + d]
        assert torch.equal(g, acc)
    nan = TPW.eval_piecewise_poly(poly, torch.tensor([float("nan"), 3.0]), 3)
    assert all(torch.isnan(c[0]) and torch.isfinite(c[1]) for c in nan)


@pytest.mark.cuda
def test_cuda_eval_piecewise_poly_ignores_tf32():
    """On the card the `"matmul"` form gives the same bits with TF32
    allowed by the caller as without, and the CPU's float32 values within
    float32 rounding (CUDA divides by a scalar through its reciprocal, so
    u may differ by an ulp: 1e-5 relative, 1e-6 absolute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    poly = TPW.fit_piecewise_poly(smooth_map, 1.0, 7.0, 32)
    v = torch.from_numpy(np.random.default_rng(4).uniform(
        1.0, 7.0, 4096).astype(np.float32))
    want = TPW.eval_piecewise_poly(poly, v, 3)
    prev = torch.backends.cuda.matmul.allow_tf32
    got = {}
    try:
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = allow
            got[allow] = TPW.eval_piecewise_poly(poly, v.cuda(), 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for on, off, w in zip(got[True], got[False], want):
        assert torch.equal(on, off)
        np.testing.assert_allclose(on.cpu().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)
