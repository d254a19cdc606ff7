"""PyTorch port: the per-step population metrics (`Engine.step_metrics`,
`Engine.simulate(record_metrics=True)`) held to the JAX package at
float64, rtol = atol = 1e-12, on the dense stage and on every `simulate`
path of the culled one (JAX's XLA pair backend)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from __graft_entry__ import _build  # noqa: E402
from cyclistsocialforce_tpu import engine as JE  # noqa: E402
from cyclistsocialforce_tpu import params as JP  # noqa: E402
from cyclistsocialforce_tpu.models import bicycle2d as jbike  # noqa: E402
from cyclistsocialforce_tpu_torch import Engine, NeighborConfig  # noqa: E402
from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.params import BicycleParams  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = dict(rtol=1e-12, atol=1e-12)
N, STEPS = 1000, 12
CFG = dict(cutoff=50.0, block=128, block_src=64, kb=16)


def engines(neighbors=None):
    """(JAX engine, port engine) of bicycle2d with the twod field; the
    culled stage with `neighbors` (NeighborConfig keywords), else dense."""
    jcfg = tcfg = None
    if neighbors is not None:
        jcfg = JE.NeighborConfig(backend="xla", **neighbors)
        tcfg = NeighborConfig(screen=False, **neighbors)
    jeng = JE.Engine.create(JP.BicycleParams.create(), jbike,
                            rep_force="twod", neighbors=jcfg)
    teng = Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                         rep_force="twod", neighbors=tcfg)
    return jeng, teng


def crowd(n, pad=None, density=0.02):
    """The bench-style crowd as (JAX state, port state), one numpy draw."""
    _, jst = _build(n, dtype=np.float64, density=density, hist_len=8,
                    pad_to_block=pad)
    return jst, convert.state_from_jax(jst, DEV)


def jax_metrics(jeng, jst, steps, **kw):
    final, m = jax.jit(lambda e, s: e.simulate(
        s, steps, record_metrics=True, **kw))(jeng, jst)
    return final, np.asarray(m)


def test_metric_names_match_jax():
    assert Engine.METRIC_NAMES == JE.Engine.METRIC_NAMES
    assert len(Engine.METRIC_NAMES) == 8


@pytest.mark.parametrize("active", ["all", "some", "none"])
def test_step_metrics_matches_jax(active):
    """Random speeds, rolls, forces and navigation states; with every
    agent inactive the means divide by 1, v_max is -inf and the other
    maxima are 0."""
    rng = np.random.default_rng(21)
    jst, _ = crowd(300)
    n = jst.n
    s = np.asarray(jst.s).copy()
    s[:, 3] = rng.uniform(-1.0, 9.0, n)
    s[:, 5] = rng.normal(size=n) * 0.3               # roll
    mask = {"all": np.ones(n, bool), "some": rng.uniform(size=n) < 0.6,
            "none": np.zeros(n, bool)}[active]
    znav = np.eye(3, dtype=bool)[rng.integers(0, 3, n)]
    jst = jst.replace(s=jnp.asarray(s), active=jnp.asarray(mask),
                      znav=jnp.asarray(znav))
    fx, fy = rng.normal(size=(2, n)) * 4
    want = np.asarray(JE.Engine.step_metrics(jst, jnp.asarray(fx),
                                             jnp.asarray(fy), 3.0))
    tst = convert.state_from_jax(jst, DEV)
    got = Engine.step_metrics(tst, torch.from_numpy(fx),
                              torch.from_numpy(fy), 3.0)
    assert got.shape == (8,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    cols = dict(zip(Engine.METRIC_NAMES, got.tolist()))
    assert cols["n_active"] == mask.sum() and cols["nbr_overflow"] == 3.0
    if active == "none":
        assert cols["v_max"] == -np.inf
        assert cols["roll_max"] == cols["f_max"] == cols["v_mean"] == 0.0
    # a 0-d tensor for the overflow count, as `simulate` passes it
    got_t = Engine.step_metrics(tst, torch.from_numpy(fx),
                                torch.from_numpy(fy), torch.tensor(3))
    assert torch.equal(got_t, got)


@pytest.mark.parametrize("path,pad,neighbors,kw", [
    ("dense", None, None, {}),
    ("per_step_rebuild", 128, dict(rebuild_every=1, **CFG), {}),
    ("per_step_gather", 128, dict(rebuild_every=5, **CFG), {}),
    ("per_step_gather_padded", None, dict(rebuild_every=5, **CFG),
     dict(record=False)),
    ("sorted_resident", 128, dict(rebuild_every=5, **CFG),
     dict(record=False)),
])
def test_simulate_metrics_match_jax(path, pad, neighbors, kw):
    """12 steps: with rebuild_every = 5 two chunks and a 2-step tail.
    record=True (the default) keeps the per-step-gather path, record=False
    takes the sorted-resident one when N is a multiple of the block."""
    n = 200 if path == "dense" else N
    jst, tst = crowd(n, pad)
    jeng, teng = engines(neighbors)
    jfin, want = jax_metrics(jeng, jst, STEPS, **kw)
    tfin, got = teng.simulate(tst, STEPS, record_metrics=True, **kw)
    assert got.shape == (STEPS, 8) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tfin.s.numpy(), np.asarray(jfin.s), rtol=0,
                               atol=1e-9)
    cols = dict(zip(Engine.METRIC_NAMES, got.numpy().T))
    assert (cols["n_active"] == n).all() and (cols["nbr_overflow"] == 0).all()
    assert (cols["f_max"] > 1.0).all() and (cols["v_max"] > 5.0).all()


def test_overflow_shows_in_metrics_as_in_jax():
    """An undersized kb gives nbr_overflow > 0 in every row (the count of
    overflowing receiver blocks, JAX's number), a sufficient kb gives 0;
    on the chunked path it is the chunk's table, on the tail the step's
    own."""
    jst, tst = crowd(256, density=256 / 150.0**2)
    for kb, overflows in ((2, True), (8, False)):
        cfg = dict(cutoff=60.0, block=32, kb=kb, rebuild_every=3)
        jeng, teng = engines(cfg)
        assert bool(teng.neighbor_cache(tst)[3].any()) == overflows
        _, want = jax_metrics(jeng, jst, 8)
        _, got = teng.simulate(tst, 8, record_metrics=True)
        ovf = got[:, Engine.METRIC_NAMES.index("nbr_overflow")].numpy()
        np.testing.assert_array_equal(ovf, want[:, 7])
        assert (ovf > 0).all() if overflows else (ovf == 0).all()
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sorted_resident_metrics_equal_gather_path():
    """The metrics do not depend on the row order: the sorted-resident
    run's equal the per-step-gather run's up to the order of the sums."""
    _, tst = crowd(N, 128)
    _, teng = engines(dict(rebuild_every=3, **CFG))
    fin_g, m_gather = teng.simulate(tst, 7, record=True, record_metrics=True)
    fin_s, m_sorted = teng.simulate(tst, 7, record=False,
                                    record_metrics=True)
    np.testing.assert_allclose(m_sorted.numpy(), m_gather.numpy(), **TOL)
    torch.testing.assert_close(fin_s.s, fin_g.s, rtol=0, atol=1e-12)


def test_record_metrics_wins_over_record_and_record_forces():
    _, tst = crowd(256, 128)
    _, teng = engines(dict(rebuild_every=2, **CFG))
    for kw in (dict(record=True), dict(record=True, record_forces=True),
               dict(record=False, record_forces=True)):
        _, got = teng.simulate(tst, 3, record_metrics=True, **kw)
        assert isinstance(got, torch.Tensor) and got.shape == (3, 8)
    _, traj = teng.simulate(tst, 3, record=True, record_forces=True)
    assert [tuple(t.shape) for t in traj] == [(3, 256, 8), (3, 256),
                                              (3, 256)]
    assert teng.simulate(tst, 3, record=False, record_forces=True)[1] is None
