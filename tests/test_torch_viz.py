"""PyTorch port: the visualization layer (`viz.py`, the port's own copy)
held to the JAX package's: the drawings' key points and the car and arrow
geometry equal JAX's; `eval_force_field` (twod and legacy fields and a
road; chunked over the points), `eval_potential_field` and `density_map`
agree with JAX's on the same numpy inputs (float64, 1e-12; counts exact,
the float32 means bit for bit on the CPU); the golden field_legacy.npz
holds; every plot function renders headlessly (Agg); `write_video`
writes a readable mp4 where OpenCV is present.
"""

import os
import tempfile
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from cyclistsocialforce_tpu_torch import Engine, viz  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, RoadElementParams, as_population)
from cyclistsocialforce_tpu_torch.road import (  # noqa: E402
    RoadSegmentCollection, build_road_elements)
from cyclistsocialforce_tpu_torch.scenario import Scenario  # noqa: E402
from cyclistsocialforce_tpu_torch.state import (make_state,  # noqa: E402
                                                set_destinations)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
F64 = torch.float64
TOL = 1e-12


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from cyclistsocialforce_tpu import Engine as JEngine
    from cyclistsocialforce_tpu import make_state as jmake_state
    from cyclistsocialforce_tpu import viz as jviz
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.params import BicycleParams as JBP
    from cyclistsocialforce_tpu.params import \
        RoadElementParams as JRoadParams
    from cyclistsocialforce_tpu.params import as_population as jpop
    from cyclistsocialforce_tpu.road import \
        RoadSegmentCollection as JColl
    from cyclistsocialforce_tpu.road import build_road_elements as jbuild

    return types.SimpleNamespace(
        viz=jviz, Engine=JEngine, make_state=jmake_state, MODELS=JMODELS,
        BP=JBP, RoadParams=JRoadParams, pop=jpop, Coll=JColl, build=jbuild)


def crowd(n=24, seed=3):
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(-8, 8, n)
    s0[:, 1] = rng.uniform(-8, 8, n)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(2, 6, n)
    active = rng.random(n) > 0.2
    return s0, active


def both_states(jx, s0, active):
    st = make_state(s0, dtype=F64, device=DEV)
    st = st.replace(active=torch.from_numpy(active))
    js = jx.make_state(s0, dtype=np.float64)
    import jax.numpy as jnp

    js = js.replace(active=jnp.asarray(active))
    return st, js


def road_pair(jx):
    pieces = [("straight", 10.0), ("curve", 5.0, np.pi / 2, "left")]
    coll = RoadSegmentCollection.chain(
        (-5.0, -3.0, 0.0), pieces, width=4.0,
        params=RoadElementParams.create(F_0=0.5, sigma=2.5))
    jcoll = jx.Coll.chain((-5.0, -3.0, 0.0), pieces, width=4.0,
                          params=jx.RoadParams.create(F_0=0.5, sigma=2.5))
    return coll, build_road_elements([coll], device=DEV), jx.build([jcoll])


def test_drawing_geometry_equals_jax(jx):
    """Bike key points, the car's polygon and the arrow's tail and head
    equal JAX's (the same numpy code); the front wheel sits a wheelbase
    ahead along psi."""
    d, jd = viz.BicycleDrawing2D(), jx.viz.BicycleDrawing2D()
    for pose in ((2.0, 3.0, np.pi / 2, 0.3), (-1.0, 0.5, -2.0, -0.4)):
        kp, jkp = d.keypoints(*pose), jd.keypoints(*pose)
        assert kp.keys() == jkp.keys()
        for k in kp:
            np.testing.assert_array_equal(kp[k], jkp[k])
    fc = d.keypoints(2.0, 3.0, np.pi / 2, 0.3)["front_wheel"].mean(axis=0)
    np.testing.assert_allclose(fc, [2.0, 3.0 + d.wheelbase], atol=1e-9)
    fig, ax = plt.subplots()
    car = viz.CarDrawing2D().draw(ax, 1.0, 2.0, 0.5)[0].get_xy()
    jcar = jx.viz.CarDrawing2D().draw(ax, 1.0, 2.0, 0.5)[0].get_xy()
    np.testing.assert_array_equal(car, jcar)
    a = viz.Arrow2D(ax, 1.0, 2.0, 3.0, -1.0, headlength=0.5, headwidth=0.3)
    ja = jx.viz.Arrow2D(ax, 1.0, 2.0, 3.0, -1.0, headlength=0.5,
                        headwidth=0.3)
    for got, want in zip(a._keypoints(1.0, 2.0, 3.0, -1.0),
                         ja._keypoints(1.0, 2.0, 3.0, -1.0)):
        np.testing.assert_array_equal(got, want)
    a.update(0.0, 0.0, 0.0, 2.0)
    np.testing.assert_allclose(np.asarray(a.head.get_xy())[0], [0.0, 2.0],
                               atol=1e-12)
    fig.canvas.draw()
    plt.close("all")


@pytest.mark.parametrize("field", ["twod", "legacy"])
def test_eval_force_field_equals_jax(jx, field, monkeypatch):
    """The summed field of the active agents and the road on a grid,
    evaluated in chunks of points (a chunk of 37 pairs per agent row
    here), equals JAX's whole-tile sum within 1e-12."""
    s0, active = crowd()
    st, js = both_states(jx, s0, active)
    coll, road, jroad = road_pair(jx)
    eng = Engine.create(as_population(BicycleParams.create(), len(s0), DEV),
                        MODELS["bicycle2d"], rep_force=field, road=road)
    jeng = jx.Engine.create(jx.pop(jx.BP.create(), len(s0)),
                            jx.MODELS["bicycle2d"], rep_force=field,
                            road=jroad)
    gx, gy = np.meshgrid(np.linspace(-10, 10, 41), np.linspace(-9, 9, 33))
    monkeypatch.setattr(viz, "FIELD_CHUNK_PAIRS", 37 * len(s0))
    for psi in (0.0, 1.2):
        got = viz.eval_force_field(gx, gy, engine=eng, state=st,
                                   psi_recv=psi, v_recv=3.0)
        want = jx.viz.eval_force_field(gx, gy, engine=jeng, state=js,
                                       psi_recv=psi, v_recv=3.0)
        for g, w in zip(got, want):
            assert g.shape == gx.shape
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    got = viz.eval_force_field(gx, gy, road=road)
    want = jx.viz.eval_force_field(gx, gy, road=jroad)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_eval_potential_field_equals_jax(jx):
    s0, active = crowd()
    st, js = both_states(jx, s0, active)
    p = as_population(BicycleParams.create(), len(s0), DEV)
    jp = jx.pop(jx.BP.create(), len(s0))
    gx, gy = np.meshgrid(np.linspace(-10, 10, 21), np.linspace(-9, 9, 17))
    for agent in (None, 3, [0, 5, 7]):
        np.testing.assert_allclose(
            viz.eval_potential_field(gx, gy, st, p, agent=agent),
            jx.viz.eval_potential_field(gx, gy, js, jp, agent=agent),
            rtol=TOL, atol=TOL)


def test_golden_field_legacy():
    """eval_potential_field / eval_force_field match the reference's
    Bicycle.calcPotential / calcRepulsiveForce on a grid (golden
    field_legacy.npz; reference vehicle.py:1066-1147)."""
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "field_legacy.npz")
    g = np.load(path)
    s0 = np.zeros((1, 5))
    s0[0, :5] = g["s"]
    st = make_state(s0, dtype=F64, device=DEV)
    p = as_population(BicycleParams.create(), 1, DEV)
    eng = Engine.create(p, MODELS["bicycle2d"])   # legacy field
    P = viz.eval_potential_field(g["gx"], g["gy"], st, p, agent=0)
    ok = np.isfinite(g["P"])   # reference NaNs at rho = 0 (no guard)
    np.testing.assert_allclose(P[ok], g["P"][ok], atol=1e-12)
    fx, fy = viz.eval_force_field(g["gx"], g["gy"], engine=eng, state=st)
    ok = np.isfinite(g["Fx"])
    np.testing.assert_allclose(fx[ok], g["Fx"][ok], atol=1e-12)
    np.testing.assert_allclose(fy[ok], g["Fy"][ok], atol=1e-12)


@pytest.mark.parametrize("bins", [4, (8, 2), 64])
def test_density_map_equals_jax(jx, bins):
    """Counts exact (inactive and outside agents dropped, the right edge
    included), the per-cell float32 means of a quantity equal JAX's."""
    rng = np.random.default_rng(5)
    n = 5000
    x = np.concatenate([rng.uniform(-1, 5, n), [0.1, 0.2, 0.9, 4.0]])
    y = np.concatenate([rng.uniform(-1, 5, n), [0.1, 0.8, 0.2, 4.0]])
    v = rng.uniform(0, 7, x.size)
    active = rng.random(x.size) > 0.1
    for vals in (None, v):
        got, ext = viz.density_map(x, y, (0, 4), (0, 4), bins=bins,
                                   values=vals, active=active, device=DEV)
        want, jext = jx.viz.density_map(x, y, (0, 4), (0, 4), bins=bins,
                                        values=vals, active=active)
        assert ext == jext and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    t = torch.from_numpy(x)
    got, _ = viz.density_map(t, torch.from_numpy(y), (0, 4), (0, 4),
                             bins=bins)
    inside = (x >= 0) & (x <= 4) & (y >= 0) & (y <= 4)
    assert got.sum() == inside.sum()


def _scenario(chunk=20):
    s0 = np.array([[-6.0, 0, 0, 5, 0], [15.0, -20, np.pi / 2, 5, 0]])
    st = make_state(s0, dtype=F64, device=DEV)
    st = set_destinations(st, 0, (35,), (0,))
    st = set_destinations(st, 1, (15,), (20,))
    p = as_population(BicycleParams.create(), 2, DEV)
    return Scenario(Engine.create(p, MODELS["bicycle2d"]), st, chunk=chunk)


def test_plots_render_headless():
    """SceneDrawing (with a road underlay and force arrows), plot_states,
    plot_forces, plot_force_field, draw_road, plot_density, plot_fft,
    fig_to_img and clear_axes, animate over the port's Scenario."""
    sc = _scenario()
    coll = RoadSegmentCollection.chain(
        (0.0, 0.0, 0.0), [("straight", 10.0)], width=4.0,
        params=RoadElementParams.create(F_0=0.5, sigma=2.5))
    _, ax = plt.subplots()
    scene = viz.SceneDrawing(ax, labels=["a", "b"], draw_forces=True,
                             road_segments=coll)
    assert len(scene.road_artists) == 3
    fx = torch.tensor([1.0, -1.0])
    arts = scene.render(sc.state, forces=(fx, fx),
                        traj_history=torch.zeros((5, 2, 8)))
    assert len(arts) > 10
    assert viz.BicycleDrawing2D().draw(ax, 0, 0, 0.0, 0.0, roll=1.0)
    final, (traj, fxs, fys) = sc.engine.simulate(sc.state, 30,
                                                 record_forces=True)
    viz.plot_states(traj, agent=0)
    viz.plot_forces(fxs, fys, agent=1)
    axes = viz.plot_force_field((-5, 10), (-5, 10), engine=sc.engine,
                                state=sc.state,
                                road=build_road_elements([coll], device=DEV),
                                grid_step=0.5, quiver_step=2.0, slice_y=0.0)
    assert len(np.atleast_1d(axes)) == 2
    im = viz.plot_density(final, bins=16)
    assert im.get_array().sum() == 2.0
    t_s = 0.01
    x = np.sin(2 * np.pi * 5.0 * np.arange(0, 2.0, t_s))
    fft_axes = viz.plot_fft(t_s, x)
    line = fft_axes[1].get_lines()[0]
    assert line.get_xdata()[np.argmax(line.get_ydata())] == pytest.approx(
        5.0, abs=0.5)
    img = viz.fig_to_img(fft_axes[0].figure)
    assert img.ndim == 3 and img.shape[2] == 4 and img.dtype == np.uint8
    viz.clear_axes(fft_axes[0])
    assert not fft_axes[0].get_lines()
    anim = viz.animate(sc, 30, xlim=(-10, 40), ylim=(-25, 25))
    anim._init_draw()
    for f in range(3):
        anim._draw_frame(f)
    assert sc.i == 4 * sc.chunk   # the init frame and 3 frames
    plt.close("all")


def test_gridsearch_and_marginal_plots():
    """plot_gridsearch of the port's fit_optimize and plot_marginals of a
    known mixture (reference PoleModel plotting,
    controlbehavior.py:1653-1830)."""
    from cyclistsocialforce_tpu_torch.behavior import GMMData
    from cyclistsocialforce_tpu_torch.gmm_fit import fit_optimize

    gmm = GMMData(means=np.array([[0.0, 0.0], [4.0, 2.0]]),
                  covariances=np.stack([np.eye(2), 0.3 * np.eye(2)]),
                  weights=np.array([0.5, 0.5]))
    X, _ = gmm.sample(120, np.random.default_rng(2))
    _, info = fit_optimize(X, range_components=(1, 3),
                           covariance_types=("full", "diag"), k_crossval=3,
                           n_init=3, n_iter=40, device=DEV)
    axes = viz.plot_gridsearch(info)
    assert len(axes) == 3 and axes[0].get_lines()
    figs = viz.plot_marginals(gmm, X_train=X[:80], X_test=X[80:], n_grid=24)
    assert len(figs) == 2
    plt.close("all")


def test_write_video():
    pytest.importorskip("cv2")
    import cv2

    sc = _scenario(chunk=25)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "run.mp4")
        viz.write_video(sc, 50, path, fps=10, dpi=60, xlim=(-10, 40),
                        ylim=(-25, 25))
        cap = cv2.VideoCapture(path)
        ok, frame = cap.read()
        cap.release()
        assert ok and frame.ndim == 3
    plt.close("all")
