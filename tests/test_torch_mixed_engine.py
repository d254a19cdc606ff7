"""PyTorch port: `MixedEngine`, a crowd of several models in one space
(bicycle2d on its legacy field beside twod on the twod field), held to
the JAX package's `MixedEngine` at float64.

On the CPU: the dense pair stage and the culled one (the kernels' plain
version in the mixed-family form) against JAX's dense and culled stages;
`test_mixed.py`'s far-apart and cross-group runs and
`test_mixed_culled.py`'s culled-equals-dense run against JAX's runs
(1e-9); the per-row field columns of groups of one and two riders; what
the port refuses; the chunk's static-buffer logic through `DirectRunner`
(tests/test_torch_graph.py) against the eager loop. On the card (`cuda`
marker): the graphed mixed run against the eager loop, bit for bit, and a
chunk with every host synchronisation an error. The JAX package comes in
through the `jx` fixture, so the card's tests also run where JAX is not
installed.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.mixed import (  # noqa: E402
    MixedEngine, prepare_groups, state_merge, state_slice)
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, InvPendulumBicycleParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402
from cyclistsocialforce_tpu_torch.state import (  # noqa: E402
    make_state, set_destinations)
from test_torch_graph import (MODES, assert_same,  # noqa: E402
                              simulate_direct, snapshot)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
TOL = 1e-9
K, STEPS = 5, 12          # two chunks and a 2-step tail


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax

    from cyclistsocialforce_tpu import Engine, make_state
    from cyclistsocialforce_tpu import mixed as JM
    from cyclistsocialforce_tpu.engine import NeighborConfig
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import prepare as jprepare
    from cyclistsocialforce_tpu.params import BicycleParams as JB
    from cyclistsocialforce_tpu.params import InvPendulumBicycleParams as JI
    from cyclistsocialforce_tpu.params import as_population as jpop
    from cyclistsocialforce_tpu.state import set_destinations as jdests

    return types.SimpleNamespace(
        jax=jax, Engine=Engine, make_state=make_state, JM=JM,
        NeighborConfig=NeighborConfig, MODELS=JMODELS, prepare=jprepare,
        Bicycle=JB, InvPendulum=JI, as_population=jpop,
        set_destinations=jdests)


def jax_groups(jx, n_legacy, n_twod):
    """`test_mixed_culled._mixed_setup`'s groups: bicycle2d on its legacy
    field, twod on the twod field (reference InvPendulumBicycle
    parameters), both per rider."""
    return [("bicycle2d", jx.as_population(jx.Bicycle.create(), n_legacy),
             n_legacy),
            ("twod", jx.as_population(jx.InvPendulum.create(), n_twod),
             n_twod)]


def mixed_setup(jx, n_legacy, n_twod, side, seed=0):
    """(JAX state, JAX groups, port state, port group specs): the crowd of
    `test_mixed_culled._mixed_setup`, its port twin through `convert`."""
    n = n_legacy + n_twod
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, side, n)
    s0[:, 1] = rng.uniform(0, side, n)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1, 6, n)
    jst = jx.make_state(s0, dtype=np.float64)
    groups = jax_groups(jx, n_legacy, n_twod)
    specs = convert.group_specs_from_jax(jx.JM.MixedEngine.create(groups),
                                         DEV)
    return jst, groups, convert.state_from_jax(jst, DEV), specs


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def test_group_specs_from_jax(jx):
    """`convert.group_specs_from_jax` names the port's modules and carries
    each group's per-rider parameters across."""
    _, groups, _, specs = mixed_setup(jx, 3, 5, 40.0)
    assert [m for m, _, _ in specs] == [MODELS["bicycle2d"], MODELS["twod"]]
    assert [n for _, _, n in specs] == [3, 5]
    assert isinstance(specs[1][1], InvPendulumBicycleParams)
    close(specs[1][1].f_0.numpy(), np.asarray(groups[1][1].f_0), 0)


def test_dense_pair_stage_matches_jax(jx):
    """The dense two-family pair stage (96 legacy + 160 twod riders in a
    120 m square) against JAX's `_repulsive`."""
    jst, groups, st, specs = mixed_setup(jx, 96, 160, 120.0)
    want = jx.JM.MixedEngine.create(groups)._repulsive(jst)
    got = MixedEngine.create(specs).repulsive_sum(st)
    for g, w in zip(got, want):
        close(g, w)


def test_culled_pair_stage_matches_dense(jx):
    """`test_mixed_culled.py`'s culled-equals-dense case: a cutoff that
    covers the square, the culled stage (K1's plain version, mixed form,
    tile screen) against JAX's dense stage and JAX's culled stage at
    backend "xla"."""
    jst, groups, st, specs = mixed_setup(jx, 96, 160, 120.0)
    dense = jx.JM.MixedEngine.create(groups)._repulsive(jst)
    jculled = jx.JM.MixedEngine.create(groups, neighbors=jx.NeighborConfig(
        cutoff=1e4, block=64, kb=4, backend="xla"))._repulsive_culled(jst)
    eng = MixedEngine.create(specs, neighbors=TE.NeighborConfig(
        cutoff=1e4, block=64, kb=4))
    assert eng.neighbors.screen
    got = eng.repulsive_sum_neighbors(st)
    for g, d, c in zip(got, dense, jculled):
        close(g, d)
        close(g, c)


@pytest.mark.parametrize("culled", [False, True])
def test_simulate_matches_jax(jx, culled):
    """`test_mixed_culled.py`'s end-to-end case: 64 + 64 riders, 7 steps
    (two 3-step chunks and a tail on the culled stage), the port against
    JAX's dense or culled `MixedEngine.simulate`."""
    jst, groups, st, specs = mixed_setup(jx, 64, 64, 80.0, seed=3)
    jcfg = pcfg = None
    if culled:
        kw = dict(cutoff=1e4, block=32, kb=8, rebuild_every=3)
        jcfg = jx.NeighborConfig(backend="xla", **kw)
        pcfg = TE.NeighborConfig(**kw)
    jeng = jx.JM.MixedEngine.create(groups, neighbors=jcfg)
    jst = jx.JM.prepare_groups(jeng, jst)
    want, wtraj = jx.jax.jit(lambda s: jeng.simulate(s, 7))(jst)
    eng = MixedEngine.create(specs, neighbors=pcfg)
    st = prepare_groups(eng, convert.state_from_jax(jst, DEV))
    got, traj = eng.simulate(st, 7)
    close(traj, wtraj)
    for f in ("s", "dest", "destpointer", "znav", "pos_hist", "i", "t_glob"):
        close(getattr(got, f), getattr(want, f))


def pair_state(s0, dests):
    """(port state, JAX-free) of `test_mixed._state`."""
    st = make_state(np.asarray(s0, dtype=np.float64), dtype=torch.float64,
                    device=DEV)
    for a, (dx, dy) in enumerate(dests):
        st = set_destinations(st, a, dx, dy)
    return st


def jax_state(jx, s0, dests):
    st = jx.make_state(np.asarray(s0, dtype=np.float64), dtype=np.float64)
    for a, (dx, dy) in enumerate(dests):
        st = jx.set_destinations(st, a, dx, dy)
    return st


def test_far_apart_groups_match_jax_and_homogeneous_engines(jx):
    """`test_mixed.py`'s far-apart case, 120 steps: two bicycle2d riders
    and two twod riders 7 km apart. The port's mixed run equals JAX's,
    and each group's rows equal the port's homogeneous engine."""
    s0_a = [[0.0, 0.0, 0.0, 4.0, 0.0], [2.0, 1.0, 0.0, 4.0, 0.0]]
    s0_b = [[5000.0, 5000.0, 0.0, 4.0, 0.0],
            [5002.0, 5001.0, 0.0, 4.0, 0.0]]
    dests_a = [((40.0,), (0.0,)), ((42.0,), (1.0,))]
    dests_b = [((5040.0,), (5000.0,)), ((5042.0,), (5001.0,))]
    steps = 120
    groups = [("bicycle2d", jx.as_population(jx.Bicycle.create(), 2), 2),
              ("twod", jx.as_population(jx.InvPendulum.create(), 2), 2)]
    jeng = jx.JM.MixedEngine.create(groups)
    jst = jx.JM.prepare_groups(jeng, jax_state(jx, s0_a + s0_b,
                                               dests_a + dests_b))
    _, want = jx.jax.jit(lambda s: jeng.simulate(s, steps))(jst)

    eng = MixedEngine.create(convert.group_specs_from_jax(jeng, DEV))
    st = prepare_groups(eng, pair_state(s0_a + s0_b, dests_a + dests_b))
    _, traj = eng.simulate(st, steps)
    close(traj, want)

    pa = as_population(BicycleParams.create(), 2, device=DEV)
    pb = as_population(InvPendulumBicycleParams.create(), 2, device=DEV)
    for rows, p, model, s0, dests in (
            (slice(0, 2), pa, MODELS["bicycle2d"], s0_a, dests_a),
            (slice(2, 4), pb, MODELS["twod"], s0_b, dests_b)):
        st = prepare(model, p, pair_state(s0, dests))
        _, alone = TE.Engine.create(p, model).simulate(st, steps)
        close(traj[:, rows], alone)


def test_cross_group_interaction_matches_jax(jx):
    """`test_mixed.py`'s cross-group case, 300 steps: a twod rider close
    alongside a bicycle2d rider deflects it (more than 1e-3 m from its
    solo run), as in JAX's run."""
    s0 = [[0.0, 0.0, 0.0, 4.0, 0.0], [2.0, 1.2, 0.0, 4.0, 0.0]]
    dests = [((60.0,), (0.0,)), ((62.0,), (1.2,))]
    steps = 300
    groups = [("bicycle2d", jx.as_population(jx.Bicycle.create(), 1), 1),
              ("twod", jx.as_population(jx.InvPendulum.create(), 1), 1)]
    jeng = jx.JM.MixedEngine.create(groups)
    jst = jx.JM.prepare_groups(jeng, jax_state(jx, s0, dests))
    _, want = jx.jax.jit(lambda s: jeng.simulate(s, steps))(jst)

    eng = MixedEngine.create(convert.group_specs_from_jax(jeng, DEV))
    st = prepare_groups(eng, pair_state(s0, dests))
    _, traj = eng.simulate(st, steps)
    close(traj, want)
    assert torch.isfinite(traj).all()

    pa = as_population(BicycleParams.create(), 1, device=DEV)
    _, solo = TE.Engine.create(pa, MODELS["bicycle2d"]).simulate(
        pair_state(s0[:1], dests[:1]), steps)
    assert (traj[:, 0, 1] - solo[:, 0, 1]).abs().max() > 1e-3


@pytest.mark.parametrize("sizes", [(1, 1), (2, 2), (3, 1)])
def test_pair_columns_per_leaf_match_jax(jx, sizes):
    """The mixed pack's per-row field columns for groups of one to three
    riders, per-rider parameters (f_0 of the twod group jittered) and
    shared ones: each leaf is per rider when it is a tensor, as
    `as_population` makes it, whatever the group's size. JAX decides by
    shape, which agrees on these groups."""
    n_leg, n_twod = sizes
    rng = np.random.default_rng(5)
    s0 = np.zeros((n_leg + n_twod, 5))
    s0[:, :2] = rng.uniform(0, 20, (n_leg + n_twod, 2))
    s0[:, 3] = rng.uniform(1, 6, n_leg + n_twod)
    jst = jx.make_state(s0, dtype=np.float64)
    f0 = 1 + 0.1 * rng.uniform(-1, 1, n_twod)
    jtwod = jx.as_population(jx.InvPendulum.create(), n_twod)
    jtwod = jtwod.replace(f_0=jtwod.f_0 * f0)
    for shared_legacy in (False, True):
        jleg = jx.Bicycle.create()
        if not shared_legacy:
            jleg = jx.as_population(jleg, n_leg)
        jeng = jx.JM.MixedEngine.create([("bicycle2d", jleg, n_leg),
                                         ("twod", jtwod, n_twod)])
        want = jeng.pack_pair_fields_mixed(jst, 128)
        eng = MixedEngine.create(convert.group_specs_from_jax(jeng, DEV))
        got = eng.pack_pair_fields(convert.state_from_jax(jst, DEV), 128)
        for g, w in zip(got, want):
            close(g, w, 1e-15)


def test_refuses_road_and_scripted():
    """Road elements and scripted agents are ported: `road=` and
    `scripted=` are taken as the JAX package's MixedEngine takes them. A
    `scripted` that is not a `ScriptedTraj` is refused, and so is the
    generic culled path ("xla"), which serves custom tiles only."""
    from cyclistsocialforce_tpu_torch.road import (build_road_elements,
                                                   straight_segment)

    specs = [("bicycle2d", BicycleParams.create(), 2)]
    road = build_road_elements([straight_segment((0, 0, 0), 4, 10)],
                               device=DEV)
    assert MixedEngine.create(specs, road=road).road is road
    sc = TE.ScriptedTraj.create(2, {0: np.zeros((4, 4))}, device=DEV)
    assert MixedEngine.create(specs, scripted=sc).scripted is sc
    with pytest.raises(TypeError, match="ScriptedTraj"):
        MixedEngine.create(specs, scripted=object())
    with pytest.raises(ValueError, match="plain version"):
        MixedEngine.create(specs, neighbors=TE.NeighborConfig(backend="xla"))


def test_state_slice_and_merge_round_trip():
    """`state_merge` of a group's slice puts every per-agent field back:
    the slice of rows [2, 5) changed is the merged state's rows [2, 5)."""
    st = build_population(8, 0.02, 16, None, torch.float64, DEV,
                          model="twod")
    sub = state_slice(st, 2, 5)
    sub = sub.replace(s=sub.s + 1.0, nq=sub.nq + 1)
    merged = state_merge(st, 2, 5, sub)
    assert torch.equal(merged.s[2:5], st.s[2:5] + 1.0)
    assert torch.equal(merged.s[:2], st.s[:2])
    assert torch.equal(merged.nq[5:], st.nq[5:])
    assert torch.equal(merged.nq[2:5], st.nq[2:5] + 1)


def mixed_engine(n, rebuild_every=K, **kw):
    """The slice's two-family engine at a small size: bicycle2d (legacy
    field) on the first half of the rows, twod on the rest, the mixed
    form with the tile screen."""
    cfg = dict(cutoff=100.0, block=128, block_src=64, kb=24,
               rebuild_every=rebuild_every)
    half = n // 2
    return MixedEngine.create(
        [("bicycle2d", BicycleParams.create(), half),
         ("twod", BicycleParams.create(), n - half)],
        neighbors=TE.NeighborConfig(**{**cfg, **kw}))


def crowd(n, device=DEV, dtype=torch.float32):
    return build_population(n, 0.02, 128, None, dtype, device, model="twod")


@pytest.mark.parametrize("mode", ["none", "metrics_gather", "states"])
def test_direct_runner_equals_eager_loop(mode):
    """The mixed chunk behind the runner's static buffers (the chunk run in
    place of a replay) equals the eager loop in every field and record;
    the rows stay in their original order (no sorted-resident chunks)."""
    eng = mixed_engine(500)
    st = crowd(500)
    want = eng.simulate(st, STEPS, graph=False, **MODES[mode])
    got = simulate_direct(eng, st, STEPS, mode)
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert runner.replays == STEPS // K and not runner.presorted
    assert torch.isfinite(got[0].s).all()


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


CARD_STEPS, CARD_K = 45, 20        # two chunks and a 5-step tail


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "metrics_gather", "states"])
def test_cuda_mixed_graph_equals_eager(cuda_device, mode):
    """The graphed mixed run equals the eager loop bit for bit; the capture
    records one launch of K1 (mixed form) per step."""
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    eng = mixed_engine(4096, rebuild_every=CARD_K, kb=40)
    st = crowd(4096, cuda_device)
    assert not eng.neighbor_cache(st)[3].any()
    want = eng.simulate(st, CARD_STEPS, graph=False, **MODES[mode])
    PF.reset_launches()
    got = eng.simulate(st, CARD_STEPS, graph=True, **MODES[mode])
    torch.cuda.synchronize()
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert runner.captured == (CARD_K, 0, 0)
    assert torch.isfinite(got[0].s).all()


@pytest.mark.cuda
def test_cuda_mixed_chunk_has_no_sync_point(cuda_device):
    """One eager mixed chunk on the card with every host synchronisation
    an error: both groups' destination forces and dynamics, the mixed
    pack and the culled stage."""
    eng = mixed_engine(4096, rebuild_every=CARD_K, kb=40)
    st = crowd(4096, cuda_device)
    cache = eng.neighbor_cache(st)
    rows = TE.record_buffers("metrics", CARD_K, st)
    eng.run_chunk(st, cache, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run_chunk(st, cache, CARD_K, False, "metrics", rows,
                      cache[3].sum())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(rows[0]).all()
