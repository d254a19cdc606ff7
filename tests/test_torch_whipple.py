"""PyTorch port: the linearized Whipple-Carvallo model (`ops.whipple`)
held to the JAX package at float64 and to the published benchmark.

The canonical matrices of both parameter sets and the 4- and 5-state
state-space forms (a number and a batch of speeds) against the JAX
functions at 1e-14 relative to the largest entry; Meijaard et al. (2007)
Table 2 (the benchmark bicycle's canonical matrices, its eigenvalues at
5 m/s and its weave speed), as tests/test_whipple.py checks the JAX
package.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch.ops import whipple as TW  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-14
PARAM_SETS = {"benchmark": TW.MEIJAARD_BENCHMARK,
              "balanceassist": TW.BALANCEASSIST_WITH_RIDER}

# Meijaard et al. (2007), Table 2 (benchmark canonical matrices)
M_REF = np.array([[80.81722, 2.31941332208709],
                  [2.31941332208709, 0.29784188199686]])
K0_REF = np.array([[-80.95, -2.59951685249872],
                   [-2.59951685249872, -0.80329488458618]])
K2_REF = np.array([[0.0, 76.59734589573222],
                   [0.0, 2.65431523794604]])


@pytest.fixture
def jx():
    """The JAX package's Whipple module used as the reference."""
    pytest.importorskip("jax")
    from cyclistsocialforce_tpu.ops import whipple as JW

    return types.SimpleNamespace(JW=JW)


def assert_rel(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_parameter_sets_are_the_jax_packages(jx):
    assert TW.MEIJAARD_BENCHMARK == jx.JW.MEIJAARD_BENCHMARK
    assert TW.BALANCEASSIST_WITH_RIDER == jx.JW.BALANCEASSIST_WITH_RIDER


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_canonical_matrices_match_jax(jx, name):
    for g, w in zip(TW.canonical_matrices(PARAM_SETS[name]),
                    jx.JW.canonical_matrices(PARAM_SETS[name])):
        assert_rel(g, w)


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_state_space_matches_jax(jx, name):
    """`state_space_4` and `state_space_5` at single speeds (0 included:
    the yaw row vanishes) and as one batch over them, float64."""
    p = PARAM_SETS[name]
    vs = [0.0, 1.25, 3.3, 5.0, 9.7]
    batch5 = TW.state_space_5(p, torch.tensor(vs, dtype=torch.float64))
    batch4 = TW.state_space_4(p, torch.tensor(vs, dtype=torch.float64))
    for i, v in enumerate(vs):
        want4 = jx.JW.state_space_4(p, v)
        want5 = jx.JW.state_space_5(p, v)
        for g, w in zip(TW.state_space_4(p, v), want4):
            assert g.dtype == torch.float64
            assert_rel(g, w)
        for g, w in zip(TW.state_space_5(p, v), want5):
            assert_rel(g, w)
        for g, w in zip(batch4, want4):
            assert_rel(g[i], w)
        for g, w in zip(batch5[:2], want5[:2]):
            assert_rel(g[i], w)
        assert_rel(batch5[2], want5[2])


def test_benchmark_canonical_matrices():
    """Meijaard et al. (2007) Table 2, tests/test_whipple.py's bar."""
    M, C1, K0, K2 = TW.canonical_matrices(TW.MEIJAARD_BENCHMARK)
    np.testing.assert_allclose(M, M_REF, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(K0, K0_REF, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(K2, K2_REF, rtol=1e-12, atol=1e-12)
    assert C1[0, 0] == 0.0


def test_benchmark_eigenvalues_and_weave_speed():
    """Meijaard et al. (2007) Table 2: the eigenvalues at 5 m/s; section
    5: self-stable between the weave speed (4.29238253634111 m/s, found by
    bisection here) and the capsize speed (~6.024 m/s)."""
    def eigs(v):
        A, _ = TW.state_space_4(TW.MEIJAARD_BENCHMARK, v)
        return np.linalg.eigvals(A.numpy())

    want = np.sort_complex(np.array([
        -14.078388992317794 + 0.0j,
        -0.775341882195845 - 4.464867713788023j,
        -0.775341882195845 + 4.464867713788023j,
        -0.322866429004087 + 0.0j]))
    np.testing.assert_allclose(np.sort_complex(eigs(5.0)), want, atol=1e-6)
    assert eigs(3.0).real.max() > 1e-3
    assert eigs(5.0).real.max() < 0.0
    assert eigs(8.0).real.max() > 0.0
    lo, hi = 3.0, 5.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if eigs(mid).real.max() > 0 else (lo, mid)
    assert abs(0.5 * (lo + hi) - 4.29238253634111) < 1e-4
