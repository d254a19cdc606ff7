"""PyTorch port: the whole culled bicycle2d slice (`Engine.simulate`) held
to the JAX package's `Engine.simulate` (XLA pair backend) at float64."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from __graft_entry__ import _build  # noqa: E402
from cyclistsocialforce_tpu import engine as JE  # noqa: E402
from cyclistsocialforce_tpu import params as JP  # noqa: E402
from cyclistsocialforce_tpu.models import bicycle2d as jbike  # noqa: E402
from cyclistsocialforce_tpu_torch import Engine, NeighborConfig  # noqa: E402
from cyclistsocialforce_tpu_torch import convert, scenarios  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.params import BicycleParams  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
N, STEPS = 1000, 12
CFG = dict(cutoff=50.0, block=128, block_src=64, kb=16)
FIELDS = ("s", "dest", "destpointer", "znav", "i", "pos_hist", "t_glob",
          "pid_e", "pid_i", "active", "uid")


def engines(rebuild_every):
    jeng = JE.Engine.create(
        JP.BicycleParams.create(), jbike, rep_force="twod",
        neighbors=JE.NeighborConfig(backend="xla",
                                    rebuild_every=rebuild_every, **CFG))
    teng = Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                         rep_force="twod",
                         neighbors=NeighborConfig(rebuild_every=rebuild_every,
                                                  screen=False, **CFG))
    return jeng, teng


def assert_close(got, want, atol=1e-9):
    for f in FIELDS:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f)


@pytest.mark.parametrize("pad,rebuild_every", [
    (128, 5),      # sorted-resident chunks + the per-step tail
    (None, 5),     # 1000 rows: per-step-gather chunks, padded packs
    (128, 1),      # per-step rebuild only
])
def test_simulate_matches_jax(pad, rebuild_every):
    """Bench-style crowd (1,000 riders at 0.02 /m^2), 12 steps: two
    rebuild chunks and a 2-step tail with rebuild_every = 5."""
    _, jst = _build(N, dtype=np.float64, density=0.02, hist_len=8,
                    pad_to_block=pad)
    tst = scenarios.build_population(N, 0.02, 8, pad, torch.float64, DEV)
    jeng, teng = engines(rebuild_every)
    want, _ = jax.jit(lambda e, s: e.simulate(s, STEPS, record=False))(
        jeng, jst)
    got, traj = teng.simulate(tst, STEPS, record=False)
    assert traj is None
    assert_close(got, want)
    moved = np.hypot(*(got.s[:N, :2] - tst.s[:N, :2]).T.numpy())
    assert moved.min() > 0.01                 # every active rider moved
    np.testing.assert_array_equal(got.s[N:].numpy(), tst.s[N:].numpy())


def test_record_path_equals_sorted_resident_and_jax_traj():
    _, jst = _build(N, dtype=np.float64, density=0.02, hist_len=8,
                    pad_to_block=128)
    tst = scenarios.build_population(N, 0.02, 8, 128, torch.float64, DEV)
    jeng, teng = engines(5)
    fin_sr, _ = teng.simulate(tst, STEPS, record=False)
    fin_rec, traj = teng.simulate(tst, STEPS, record=True)
    assert traj.shape == (STEPS, tst.n, 8)
    for f in FIELDS:
        torch.testing.assert_close(getattr(fin_rec, f), getattr(fin_sr, f),
                                   atol=1e-12, rtol=0)
    torch.testing.assert_close(traj[-1], fin_rec.s, atol=0, rtol=0)
    _, jtraj = jax.jit(lambda e, s: e.simulate(s, STEPS, record=True))(
        jeng, jst)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=1e-9)


def test_step_and_state_round_trip():
    """One `Engine.step` (per-step table) equals JAX's on a state handed
    over through `convert.state_from_jax`."""
    _, jst = _build(300, dtype=np.float64, density=0.02, hist_len=8,
                    pad_to_block=128)
    jeng, teng = engines(1)
    want = jax.jit(lambda e, s: e.step(s))(jeng, jst)
    got = teng(convert.state_from_jax(jst, device=DEV))
    assert_close(got, want, atol=1e-12)


def test_create_rejects_unported_configurations():
    """The legacy field (bicycle2d's default) and the dense stage are
    ported; what is not still raises."""
    p = BicycleParams.create()
    model = MODELS["bicycle2d"]
    culled = Engine.create(p, model, neighbors=NeighborConfig())
    assert culled.pair_family == "legacy" and culled.uniform_pair is None
    dense = Engine.create(p, model, rep_force="twod")
    assert dense.neighbors is None and dense.pair_family == "twod"
    assert dense.uniform_pair is not None
    with pytest.raises(NotImplementedError):
        Engine.create(p, model, rep_force="twod", dest_force="spline",
                      neighbors=NeighborConfig())
    with pytest.raises(NotImplementedError):
        Engine.create(p, model, rep_force=lambda *a: None)
    with pytest.raises(NotImplementedError):
        Engine.create(p, model, rep_reduce=lambda *a: None)
    with pytest.raises(NotImplementedError):
        Engine.create(p, model, combine_forces=lambda *a: None)
    with pytest.raises(ValueError):
        NeighborConfig(block=128, block_src=48)
