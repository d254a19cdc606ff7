"""PyTorch port: the scenario runner (`scenario.py`): chunked stepping,
determinism, checkpoint and resume, pacing, callbacks and metrics, the
nine cases of tests/test_scenario.py on the port's `Scenario`; the runs
held to the JAX package's in float64; checkpoints in the JAX package's
npz layout, so that a state saved by either package resumes in the other
(a JAX checkpoint resumed by the port matches JAX's own resumed run at
1e-12).
"""

import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, as_population)
from cyclistsocialforce_tpu_torch.scenario import (  # noqa: E402
    RuntimeMetrics, Scenario, load_checkpoint, save_checkpoint)
from cyclistsocialforce_tpu_torch.state import (make_state,  # noqa: E402
                                                set_destinations)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
F64 = torch.float64

# tests/test_scenario.py's three riders: one along x, two side by side
# crossing it
S0 = np.array([[-6.0, 0, 0, 5, 0],
               [15.0, -20, np.pi / 2, 5, 0],
               [13.0, -20, np.pi / 2, 5, 0]])
DESTS = [((35, 64, 65), (0, 0, 0)), ((15, 15, 15), (20, 49, 50)),
         ((13, 13, 13), (20, 49, 50))]


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax

    from cyclistsocialforce_tpu import engine, make_state, params, scenario
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import prepare as jprepare
    from cyclistsocialforce_tpu.state import set_destinations as jset

    return types.SimpleNamespace(jax=jax, JE=engine, JP=params, JSC=scenario,
                                 make_state=make_state, MODELS=JMODELS,
                                 prepare=jprepare, set_destinations=jset)


def scene_state(params, device=DEV):
    st = make_state(S0, dtype=F64, device=device)
    for a, (x, y) in enumerate(DESTS):
        st = set_destinations(st, a, x, y)
    return prepare(MODELS["bicycle2d"], params, st)


def _scenario(chunk=50, run_time_factor=None, neighbors=None):
    p = as_population(BicycleParams.create(), 3, device=DEV)
    eng = TE.Engine.create(p, MODELS["bicycle2d"], neighbors=neighbors)
    return Scenario(eng, scene_state(p), chunk=chunk,
                    run_time_factor=run_time_factor)


def jax_scenario(jx, chunk=50):
    st = jx.make_state(S0, dtype=np.float64)
    for a, (x, y) in enumerate(DESTS):
        st = jx.set_destinations(st, a, x, y)
    p = jx.JP.as_population(jx.JP.BicycleParams.create(), 3)
    model = jx.MODELS["bicycle2d"]
    st = jx.prepare(model, p, st)
    return jx.JSC.Scenario(jx.JE.Engine.create(p, model), st, chunk=chunk)


def test_run_by_time_and_record(jx):
    """run(t_end=1.0) is 100 steps: [100, 3, 8] finite records, the
    JAX package's to 1e-12."""
    sc = _scenario(chunk=40)
    traj = sc.run(t_end=1.0, record=True)
    assert traj.shape == (100, 3, 8)
    assert sc.i == 100
    assert np.all(np.isfinite(traj))
    want = jax_scenario(jx, chunk=40).run(t_end=1.0, record=True)
    np.testing.assert_allclose(traj, want, rtol=0, atol=1e-12)


def test_chunking_invariance():
    """The chunk size does not change the physics: chunk=7 == chunk=100."""
    a = _scenario(chunk=7).run(n_steps=140, record=True)
    b = _scenario(chunk=100).run(n_steps=140, record=True)
    np.testing.assert_array_equal(a, b)


def test_determinism_same_seed():
    """Same inputs: bit-identical runs."""
    a = _scenario().run(n_steps=200, record=True)
    b = _scenario().run(n_steps=200, record=True)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
def test_checkpoint_resume_bitexact(tmp_path, culled):
    """Checkpoint at step 100 and resume in a fresh scenario: identical to
    the uninterrupted run, bit for bit (on the culled stage too, whose
    chunks then start at the same steps)."""
    nbr = (TE.NeighborConfig(cutoff=100.0, block=8, kb=2, rebuild_every=10)
           if culled else None)
    ref = _scenario(neighbors=nbr).run(n_steps=300, record=True)
    first = _scenario(neighbors=nbr)
    first.run(n_steps=100)
    path = tmp_path / "ckpt.npz"
    first.checkpoint(path)
    resumed = _scenario(neighbors=nbr)
    meta = resumed.restore(path)
    assert resumed.i == 100 and meta["i"] == 100 and meta["t_s"] == 0.01
    tail = resumed.run(n_steps=200, record=True)
    np.testing.assert_array_equal(tail, ref[100:])


def test_checkpoint_roundtrip_all_leaves(tmp_path):
    """Every field comes back with its value, dtype and device."""
    sc = _scenario()
    sc.run(n_steps=37)
    path = tmp_path / "s.npz"
    save_checkpoint(path, sc.state, extra={"note": "x"})
    restored, meta = load_checkpoint(path, sc.state)
    assert meta["note"] == "x"
    for f in TE._STATE_FIELDS:
        a, b = getattr(sc.state, f), getattr(restored, f)
        assert a.dtype == b.dtype and a.device == b.device, f
        assert torch.equal(a, b), f
    bad = sc.state.replace(s=sc.state.s[:2])
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, bad)


def test_checkpoint_is_the_jax_layout(jx, tmp_path):
    """The port writes the JAX package's keys, dtypes and shapes (the key
    as two uint32 words), and the JAX package loads it back equal."""
    sc = _scenario()
    sc.run(n_steps=23)
    mine, theirs = tmp_path / "torch.npz", tmp_path / "jax.npz"
    sc.checkpoint(mine)
    js = jax_scenario(jx)
    js.run(n_steps=23)
    js.checkpoint(theirs)
    with np.load(mine) as a, np.load(theirs) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k != "__meta__":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12)
        assert json.loads(bytes(a["__meta__"]).decode()) == {"i": 23,
                                                              "t_s": 0.01}
    loaded, meta = jx.JSC.load_checkpoint(mine, js.state)
    assert meta["i"] == 23
    for f in TE._STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, f)),
                                      _jaxlike(getattr(sc.state, f), f))


def _jaxlike(t, field):
    arr = t.numpy()
    return arr.astype(np.uint32) if field == "key" else arr


def test_jax_checkpoint_resumes_in_the_port(jx, tmp_path):
    """A checkpoint written by the JAX package at step 100, resumed by the
    port for 200 steps, matches the JAX package's own resumed run in
    float64 at 1e-12."""
    js = jax_scenario(jx)
    js.run(n_steps=100)
    path = tmp_path / "jax.npz"
    js.checkpoint(path)
    jres = jax_scenario(jx)
    jres.restore(path)
    want = jres.run(n_steps=200, record=True)

    sc = _scenario()
    meta = sc.restore(path)
    assert sc.i == 100 and meta["i"] == 100
    assert sc.state.key.dtype == torch.int64
    np.testing.assert_array_equal(sc.state.key.numpy(),
                                  np.asarray(jres.state.key))
    got = sc.run(n_steps=200, record=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_callback_fires_per_chunk():
    sc = _scenario(chunk=25)
    seen = []
    sc.run(n_steps=100, callback=lambda i, st, tr: seen.append(
        (i, None if tr is None else tuple(tr.shape))))
    assert [s[0] for s in seen] == [25, 50, 75, 100]
    assert all(s[1] == (25, 3, 8) for s in seen)


def test_metrics_and_pacing():
    """40 steps at t_s = 0.01 and factor 20 take >= 20 ms of wall time;
    the metrics count the steps and agent-steps."""
    sc = _scenario(chunk=20, run_time_factor=20.0)
    t0 = time.perf_counter()
    sc.run(n_steps=40)
    wall = time.perf_counter() - t0
    assert wall >= 0.02
    s = sc.metrics.summary()
    assert s["total_steps"] == 40
    assert sc.metrics.agent_steps_per_sec() == pytest.approx(
        3 * sc.metrics.steps_per_sec(), rel=1e-6)
    assert sc.metrics.step_wall_times().shape == (2,)
    m = RuntimeMetrics()
    m.record(10, 0.5, 4)
    assert m.steps_per_sec() == 20.0 and m.agent_steps_per_sec() == 80.0


def test_reset():
    sc = _scenario()
    sc.run(n_steps=50)
    sc.reset()
    assert sc.i == 0 and sc.metrics.total_steps == 0
    assert torch.equal(sc.state.s, sc.state0.s)


def test_device_metrics_buffer():
    """simulate(record_metrics=True) returns the [T, 8] per-step
    aggregates."""
    sc = _scenario()
    _, metrics = sc.engine.simulate(sc.state, 60, record_metrics=True)
    m = metrics.numpy()
    assert m.shape == (60, len(sc.engine.METRIC_NAMES))
    cols = dict(zip(sc.engine.METRIC_NAMES, m.T))
    assert np.all(cols["n_active"] == 3)
    assert np.all(cols["v_mean"] > 0)
    assert np.all(cols["v_max"] >= cols["v_mean"])
    assert np.all(cols["f_max"] >= cols["f_mean"])
    assert np.all((cols["arrived_frac"] >= 0) & (cols["arrived_frac"] <= 1))
