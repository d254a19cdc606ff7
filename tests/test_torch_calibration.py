"""PyTorch port: the calibration (`calibration.py`) held to the JAX
package's on the cases of tests/test_calibration.py: the same synthetic
bicycle2d tracks (tests/test_calibration.py's `_make_tracks`, numpy
seeded), the port's replay on the CPU in float64. Objectives, the
candidate batch, the optimum, test errors and per-track errors agree with
JAX's at 1e-10 relative (an objective at the truth, ~1e-30 in both, at
1e-20 absolute).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_calibration import _make_tracks  # noqa: E402

from cyclistsocialforce_tpu_torch.calibration import (  # noqa: E402
    Calibration, CalibrationData, maesse_samples, sse_timesteps)
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.params import BicycleParams  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
RTOL, ATOL = 1e-10, 1e-20


@pytest.fixture(scope="module")
def jx():
    from cyclistsocialforce_tpu import calibration
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.params import BicycleParams as JBP

    return types.SimpleNamespace(C=calibration, MODELS=JMODELS, BP=JBP)


def port_data(d):
    return CalibrationData(d.s0, d.inputs, d.objectives, d.lengths)


def pair(jx, data, **kw):
    """(port, JAX) calibrations of bicycle2d's k_p_v on the same data."""
    kw = {"objective_features": (0, 1), "fix_speed": False,
          "verbose": False, **kw}
    test = kw.pop("test_data", None)
    port = Calibration(MODELS["bicycle2d"], BicycleParams.create(),
                       ["k_p_v"], port_data(data),
                       test_data=None if test is None else port_data(test),
                       device=DEV, **kw)
    jax_kw = dict(kw)
    if "params_auxfuncs" in jax_kw:
        import jax.numpy as jnp

        jax_kw["params_auxfuncs"] = [lambda v: jnp.exp(v[0])]
    ref = jx.C.Calibration(jx.MODELS["bicycle2d"], jx.BP.create(),
                           ["k_p_v"], data, test_data=test, **jax_kw)
    return port, ref


def test_objective_zero_at_truth(jx):
    port, ref = pair(jx, _make_tracks(k_p_v=10.0))
    for v in (10.0, 5.0, 12.5):
        np.testing.assert_allclose(port.objective([v]), ref.objective([v]),
                                   rtol=RTOL, atol=ATOL)
    assert port.objective([10.0]) < 1e-16
    assert port.objective([5.0]) > 1e-4


def test_recovers_known_parameter(jx):
    port, ref = pair(jx, _make_tracks(k_p_v=10.0), maxiter=60)
    xp, rp = port.run([5.0])
    xj, rj = ref.run([5.0])
    np.testing.assert_allclose(xp, xj, rtol=RTOL)
    assert (rp["iters"], rp["calls"]) == (rj["iters"], rj["calls"])
    assert abs(xp[0] - 10.0) < 0.05 and rp["error"] < 1e-8


def test_population_evaluation_matches_scalar(jx):
    port, ref = pair(jx, _make_tracks())
    cands = np.array([[5.0], [8.0], [10.0], [12.0]])
    errs = port.evaluate_population(cands)
    singles = [port.objective(c) for c in cands]
    np.testing.assert_allclose(errs, singles, rtol=1e-12, atol=ATOL)
    np.testing.assert_allclose(errs, ref.evaluate_population(cands),
                               rtol=RTOL, atol=ATOL)
    assert np.argmin(errs) == 2


def test_fix_speed_clamps_speed(jx):
    data = _make_tracks()
    port, ref = pair(jx, data, objective_features=(3,), fix_speed=True)
    out = port.simulate(port.params, port.train_data).numpy()
    want = np.asarray(ref.simulate(ref.params, data))
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=1e-12)
    vin = np.hypot(data.inputs[..., 0], data.inputs[..., 1])
    assert np.max(np.abs(out[:, 1:, 0] - vin[:, :-1])) < 0.5
    np.testing.assert_allclose(port.objective([7.0]), ref.objective([7.0]),
                               rtol=RTOL)


def test_auxfuncs_transform(jx):
    """The optimizer in log space: k_p_v = exp(vals[0]), a tensor
    function of the candidate vector."""
    port, ref = pair(jx, _make_tracks(k_p_v=10.0), maxiter=60,
                     params_auxfuncs=[lambda v: torch.exp(v[0])])
    xp, _ = port.run([np.log(5.0)])
    xj, _ = ref.run([np.log(5.0)])
    np.testing.assert_allclose(xp, xj, rtol=RTOL)
    assert abs(np.exp(xp[0]) - 10.0) < 0.05


def test_split_and_test_error(jx):
    data = _make_tracks(n_tracks=8)
    train, test = port_data(data).split(0.75, rng=np.random.default_rng(1))
    jtrain, jtest = data.split(0.75, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(train.s0, jtrain.s0)
    np.testing.assert_array_equal(test.inputs, jtest.inputs)
    assert len(train) == 6 and len(test) == 2
    port, ref = pair(jx, jtrain, test_data=jtest, maxiter=60)
    port.run([6.0])
    ref.run([6.0])
    np.testing.assert_allclose(port.test(), ref.test(), rtol=RTOL,
                               atol=ATOL)
    assert port.test() < 1e-6


def test_result_diagnostics_plot_and_per_track_errors(jx):
    """test(plot=True) renders one axis per test track (Agg) with the
    measurement and simulation lines; the per-track errors equal JAX's
    and sum to the test error; the heading objective draws the
    reference-input line as well."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = _make_tracks(n_tracks=8)
    train, test = data.split(0.75, rng=np.random.default_rng(1))
    port, ref = pair(jx, train, test_data=test, maxiter=60)
    port.run([6.0])
    ref.run([6.0])
    err, fig = port.test(plot=True, name="calibrated")
    assert len(fig.axes) == len(test)
    assert all(len(ax.lines) == 2 * 2 for ax in fig.axes)
    errs, out = port.per_track_errors()
    jerrs, jout = ref.per_track_errors()
    np.testing.assert_allclose(errs, jerrs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-12)
    assert out.shape == (len(test), data.inputs.shape[1], 2)
    np.testing.assert_allclose(errs.sum(), err, rtol=1e-10)
    data_psi = _make_tracks(n_tracks=8, features=(2,))
    train, test = data_psi.split(0.75, rng=np.random.default_rng(1))
    port, ref = pair(jx, train, test_data=test, objective_features=(2,),
                     maxiter=5)
    port.run([9.0])
    ref.run([9.0])
    np.testing.assert_allclose(port.result["x"], ref.result["x"], rtol=RTOL)
    err2, fig2 = port.test(plot=True, plot_inref=True)
    assert all(len(ax.lines) == 3 for ax in fig2.axes)
    np.testing.assert_allclose(err2, ref.test(), rtol=RTOL, atol=ATOL)
    plt.close("all")


def test_error_functions_masking(jx):
    out = np.ones((2, 4, 1))
    obj = np.zeros((2, 4, 1))
    obj[1, 2, 0] = 3.0
    mask = np.asarray([[1, 1, 0, 0], [1, 1, 1, 1]], dtype=np.float64)
    t = [torch.from_numpy(a) for a in (out, obj, mask)]
    import jax.numpy as jnp

    j = [jnp.asarray(a) for a in (out, obj, mask)]
    assert float(sse_timesteps(*t)) == float(jx.C.sse_timesteps(*j)) == 9.0
    assert float(maesse_samples(*t)) == pytest.approx(
        float(jx.C.maesse_samples(*j)), rel=1e-15)
    t[1][1, 2, 0] = 0.0
    assert float(maesse_samples(*t)) == pytest.approx(2.0)


def test_convert_calibration_data_from_jax(jx):
    from cyclistsocialforce_tpu_torch import convert

    data = _make_tracks(n_tracks=3)
    got = convert.calibration_data_from_jax(data)
    assert isinstance(got, CalibrationData) and len(got) == 3
    for f in ("s0", "inputs", "objectives", "lengths"):
        np.testing.assert_array_equal(getattr(got, f), getattr(data, f))
        assert getattr(got, f) is not getattr(data, f)
