"""PyTorch port: `parallel.sharding` held to the JAX package's sharded
runs (`shard_map` over conftest's virtual CPU devices) on the same
numpy-seeded inputs, float64 on the CPU: every float leaf of the final
state within 1e-9, integer leaves exact. JAX's culled side runs its "xla"
backend, the port's the pair kernel's plain version.

The port's sharded runs are also held to its own single-device
`Engine.simulate` at the JAX package's bars (tests/test_sharding.py):
1e-12 for allgather, halo, the balancing rider and the mixed crowd, 1e-9
for the dense ring (it re-associates the source sum per hop), 2e-5 for a
culled schedule against a different block partition. The port's mesh is
one process holding D shards in lockstep; JAX's has D virtual devices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu import Engine as JEngine  # noqa: E402
from cyclistsocialforce_tpu import make_state as jmake_state  # noqa: E402
from cyclistsocialforce_tpu import parallel as JPAR  # noqa: E402
from cyclistsocialforce_tpu.engine import NeighborConfig as JNC  # noqa: E402
from cyclistsocialforce_tpu.engine import ScriptedTraj as JST  # noqa: E402
from cyclistsocialforce_tpu.mixed import MixedEngine as JMixed  # noqa: E402
from cyclistsocialforce_tpu.mixed import prepare_groups as jprep_groups  # noqa: E402,E501
from cyclistsocialforce_tpu.models import MODELS as JMODELS  # noqa: E402
from cyclistsocialforce_tpu.models import prepare as jprepare  # noqa: E402
from cyclistsocialforce_tpu.params import (  # noqa: E402
    BalancingRiderParams as JBRP)
from cyclistsocialforce_tpu.params import BicycleParams as JBP  # noqa: E402
from cyclistsocialforce_tpu.params import (  # noqa: E402
    InvPendulumBicycleParams as JIPP)
from cyclistsocialforce_tpu.params import as_population as jas_pop  # noqa: E402,E501
from cyclistsocialforce_tpu.state import set_destinations as jset  # noqa: E402,E501
from cyclistsocialforce_tpu_torch import Engine, NeighborConfig  # noqa: E402
from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import parallel as P  # noqa: E402
from cyclistsocialforce_tpu_torch.engine import (  # noqa: E402
    ScriptedTraj, rep_tile_twod, sorted_packs)
from cyclistsocialforce_tpu_torch.mixed import MixedEngine  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.parallel import sharding as S  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BalancingRiderParams, BicycleParams, InvPendulumBicycleParams,
    as_population)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
D = 4         # shards on both sides (JAX: the first 4 virtual devices)
TOL = 1e-9    # the port against JAX, float leaves


def jmesh():
    return JPAR.make_mesh(D)


def tmesh():
    return P.make_mesh(D, device=DEV)


def tstate(jst):
    return convert.state_from_jax(jst, DEV)


def assert_matches_jax(got, want, atol=TOL):
    """Every leaf of the port's AgentState `got` against JAX's `want`:
    float leaves within `atol`, integer and bool leaves exact (the key's
    uint32 words as int64)."""
    for f in dataclasses.fields(got):
        g = getattr(got, f.name).detach().cpu().numpy()
        w = np.asarray(getattr(want, f.name))
        if f.name == "key":
            w = w.astype(np.int64)
        assert g.shape == w.shape, f.name
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f.name)


def sharded_run(engine, state, steps, **kw):
    """The port's sharded run, gathered: (final state, records)."""
    mesh = tmesh()
    out = P.sharded_simulate_fn(engine, mesh, steps, **kw)(
        P.shard_state(state, mesh))
    final = P.gather_state(out[0], mesh)
    if kw.get("comm") == "halo":
        return final, out[1]
    recs = None if out[1] is None else torch.cat(out[1], dim=1)
    return final, recs


def jax_sharded_run(engine, state, steps, **kw):
    mesh = jmesh()
    run = JPAR.sharded_simulate_fn(engine, mesh, steps, **kw)
    return run(JPAR.shard_state(state, mesh))


def single(engine, state, steps, **kw):
    return engine.simulate(state, steps, record=False, **kw)[0]


def assert_states_close(a, b, atol, fields=("s",)):
    for f in fields:
        err = float((getattr(a, f) - getattr(b, f)).abs().max())
        assert err <= atol, (f, err)


# ---- populations (the JAX package's tests/test_sharding.py setups) ----


def _setup(n):
    rng = np.random.default_rng(0)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(-30, 30, n)
    s0[:, 1] = rng.uniform(-30, 30, n)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1, 6, n)
    st = jmake_state(s0, dtype=np.float64)
    for a in range(n):
        st = jset(st, a, (rng.uniform(-50, 50),), (rng.uniform(-50, 50),))
    return (JEngine.create(JBP.create(), JMODELS["bicycle2d"]),
            Engine.create(BicycleParams.create(), MODELS["bicycle2d"]), st)


def _spread(n, seed, side, hist_len=128):
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(-side, side, n)
    s0[:, 1] = rng.uniform(-side, side, n)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1, 6, n)
    st = jmake_state(s0, dtype=np.float64, hist_len=hist_len)
    for a in range(n):
        st = jset(st, a, (rng.uniform(-side, side),),
                  (rng.uniform(-side, side),))
    return st


def _culled(cutoff, block, kb, rebuild_every, block_src=0,
            sorted_resident=None):
    cfg = dict(cutoff=cutoff, block=block, kb=kb,
               rebuild_every=rebuild_every, block_src=block_src)
    jeng = JEngine.create(JBP.create(), JMODELS["bicycle2d"],
                          rep_force="twod",
                          neighbors=JNC(backend="xla", **cfg),
                          sorted_resident=sorted_resident)
    teng = Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                         rep_force="twod",
                         neighbors=NeighborConfig(screen=False, **cfg),
                         sorted_resident=sorted_resident)
    return jeng, teng


def _setup_culled(n, block=16, block_src=0, rebuild_every=4):
    side = 0.5 * np.sqrt(n / 0.02)             # the bench density
    return (*_culled(60.0, block, n // (block_src or block), rebuild_every,
                     block_src), _spread(n, 1, side))


def _setup_halo(n, kb=64, block=16, block_src=0, sorted_resident=None):
    side = 0.5 * np.sqrt(n / 0.02)
    return (*_culled(20.0, block, kb, 4, block_src, sorted_resident),
            _spread(n, 3, side, hist_len=16))


# ---- Engine.repulsive_sum with gathered sources ----


def test_repulsive_sum_takes_jax_source_keywords():
    """A 64-rider shard (global rows 128-191) against all-gathered
    256-rider sources with per-agent hfov: the port's
    `Engine.repulsive_sum(state, src, idx_src, active_src, hfov_src,
    recv_offset)` against JAX's at 1e-12."""
    n, lo, nl = 256, 128, 64
    rng = np.random.default_rng(4)
    s0 = np.c_[rng.uniform(-20, 20, (n, 2)), rng.uniform(-np.pi, np.pi, n),
               rng.uniform(1, 6, n)]
    hfov = rng.uniform(0.5 * np.pi, 1.8 * np.pi, n)
    active = rng.uniform(size=n) > 0.1
    jst = jmake_state(s0, dtype=np.float64).replace(
        active=jnp.asarray(active))
    jeng = JEngine.create(jas_pop(JBP.create(), n).replace(
        hfov=jnp.asarray(hfov)), JMODELS["bicycle2d"])
    teng = Engine.create(as_population(BicycleParams.create(), n, DEV)
                         .replace(hfov=torch.as_tensor(hfov)),
                         MODELS["bicycle2d"])
    tst = tstate(jst)

    def local(st, take):
        return st.replace(s=take(st.s), active=take(st.active))

    jl = local(jst, lambda a: a[lo:lo + nl])
    tl = local(tst, lambda a: a[lo:lo + nl])
    want = jeng.repulsive_sum(
        jl, src=jeng._src_bundle(jst), idx_src=jnp.arange(n),
        active_src=jst.active, hfov_src=jnp.asarray(hfov), recv_offset=lo)
    got = teng.repulsive_sum(
        tl, teng._src_bundle(tst), torch.arange(n), tst.active,
        torch.as_tensor(hfov), lo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    assert float(np.abs(np.asarray(want[0])).max()) > 0.1
    # the receivers' own rows are excluded by their global index
    full = teng.repulsive_sum(tst)
    np.testing.assert_allclose(got[0].numpy(), full[0][lo:lo + nl].numpy(),
                               rtol=0, atol=1e-12)


# ---- dense schedules ----


@pytest.fixture(scope="module")
def dense():
    jeng, teng, jst = _setup(4 * D)
    return jeng, teng, jst, tstate(jst)


@pytest.mark.parametrize("comm", ["allgather", "ring"])
def test_dense_step_with_forces(dense, comm):
    jeng, teng, jst, tst = dense
    jmesh_ = jmesh()
    want, wfx, wfy = JPAR.sharded_step_fn(jeng, jmesh_, with_forces=True,
                                          comm=comm)(
        JPAR.shard_state(jst, jmesh_))
    mesh = tmesh()
    sts, fx, fy = P.sharded_step_fn(teng, mesh, with_forces=True,
                                    comm=comm)(P.shard_state(tst, mesh))
    got = P.gather_state(sts, mesh)
    assert_matches_jax(got, want)
    fx, fy = mesh.all_gather(fx), mesh.all_gather(fy)
    np.testing.assert_allclose(fx.numpy(), np.asarray(wfx), atol=TOL)
    np.testing.assert_allclose(fy.numpy(), np.asarray(wfy), atol=TOL)
    ref, rfx, rfy = teng.step_with_forces(tst)
    bar = 1e-12 if comm == "allgather" else 1e-9
    assert_states_close(got, ref, bar)
    assert float((fx - rfx).abs().max()) <= bar
    assert float(fx.abs().max()) > 0.1


@pytest.mark.parametrize("comm", ["allgather", "ring"])
def test_dense_simulate_records(comm):
    jeng, teng, jst = _setup(2 * D)
    tst = tstate(jst)
    want, wtraj = jax_sharded_run(jeng, jst, 30, record=True, comm=comm)
    got, traj = sharded_run(teng, tst, 30, record=True, comm=comm)
    assert_matches_jax(got, want)
    np.testing.assert_allclose(traj.numpy(), np.asarray(wtraj), atol=TOL)
    ref, rtraj = teng.simulate(tst, 30)
    bar = 1e-12 if comm == "allgather" else 1e-9
    assert float((traj - rtraj).abs().max()) <= bar


def test_dense_combine_forces_hook(dense):
    """A custom combine_forces hook shapes the sharded step as the
    single-device one (tests/test_sharding.py's no-clamp case)."""
    tst = dense[3]

    def no_clamp(frx, fry, fdx, fdy):
        return frx + fdx, fry + fdy

    eng = Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                        combine_forces=no_clamp)
    mesh = tmesh()
    sts, fx, _ = P.sharded_step_fn(eng, mesh, with_forces=True)(
        P.shard_state(tst, mesh))
    ref, rfx, _ = eng.step_with_forces(tst)
    assert_states_close(P.gather_state(sts, mesh), ref, 1e-12)
    assert float((mesh.all_gather(fx) - rfx).abs().max()) <= 1e-12


# ---- culled schedules ----


@pytest.fixture(scope="module")
def culled():
    jeng, teng, jst = _setup_culled(512)
    return jeng, teng, jst, tstate(jst)


@pytest.mark.parametrize("comm", ["allgather", "ring"])
def test_culled_matches_jax_and_single_device(culled, comm):
    """Culled allgather and ring, 12 steps (three rebuild chunks, the
    rows sorted-resident): the same local sorts and tables as JAX's, and
    within the culled bar of the single-device run (another block
    partition)."""
    jeng, teng, jst, tst = culled
    want, _ = jax_sharded_run(jeng, jst, 12, comm=comm)
    got, _ = sharded_run(teng, tst, 12, comm=comm)
    assert_matches_jax(got, want)
    ref = single(teng, tst, 12)
    assert_states_close(got, ref, 2e-5)
    assert float((got.s[:, :2] - tst.s[:, :2]).abs().max()) > 0.1


def test_culled_ring_equals_allgather_step(culled):
    """One step with forces: the ring evaluates exactly the allgather's
    tiles (hop by hop), so the forces agree to re-association."""
    _, teng, _, tst = culled
    mesh = tmesh()
    shards = P.shard_state(tst, mesh)
    _, fa, _ = P.sharded_step_fn(teng, mesh, with_forces=True)(shards)
    _, fr, _ = P.sharded_step_fn(teng, mesh, with_forces=True,
                                 comm="ring")(shards)
    fa, fr = mesh.all_gather(fa), mesh.all_gather(fr)
    assert float((fa - fr).abs().max()) <= 1e-10
    assert float(fa.abs().max()) > 0.1


@pytest.mark.parametrize("comm", ["allgather", "ring"])
def test_culled_asymmetric_source_blocks(comm):
    """block_src < block: the gathered source boxes at the finer grain."""
    jeng, teng, jst = _setup_culled(512, block=16, block_src=8)
    tst = tstate(jst)
    want, _ = jax_sharded_run(jeng, jst, 12, comm=comm)
    got, _ = sharded_run(teng, tst, 12, comm=comm)
    assert_matches_jax(got, want)
    assert_states_close(got, single(teng, tst, 12), 2e-5)


def test_sorted_resident_chunks_with_remainder(culled):
    """14 steps at rebuild_every 4: three sorted-resident chunks and a
    2-step remainder that rebuilds every step; against JAX's run and the
    port's per-step gather path (record=True, rows never permuted)."""
    jeng, teng, jst, tst = culled
    want, _ = jax_sharded_run(jeng, jst, 14)
    got, _ = sharded_run(teng, tst, 14)
    assert_matches_jax(got, want)
    gathered, traj = sharded_run(teng, tst, 14, record=True)
    assert traj.shape == (14, tst.n, 8)
    np.testing.assert_array_equal(traj[-1].numpy(), gathered.s.numpy())
    # the two paths feed the sort in different row orders (ties)
    assert_states_close(got, gathered, 1e-6)
    np.testing.assert_array_equal(got.uid.numpy(), tst.uid.numpy())


# ---- the halo schedule ----


@pytest.fixture(scope="module")
def halo_crowd():
    return _setup_halo(512 * D)


@pytest.mark.parametrize("sorted_resident", [True, False])
def test_halo_matches_jax_and_single_device(halo_crowd, sorted_resident):
    """The halo schedule, 10 steps (two chunks of 4 and a remainder of
    2): JAX's run and the port's single-device culled run exactly, for a
    sorted-resident engine and for one that sorts from original order
    (`from_original`)."""
    _, _, jst = halo_crowd
    jeng, teng = _culled(20.0, 16, 64, 4, 0, sorted_resident)
    tst = tstate(jst)
    h = P.required_halo(teng, tst, D)
    assert h == JPAR.required_halo(jeng, jst, D)
    h += 1
    assert h * 16 < tst.n // D                # a strict part of a strip
    want, wovf = jax_sharded_run(jeng, jst, 10, comm="halo", halo=h)
    got, ovf = sharded_run(teng, tst, 10, comm="halo", halo=h)
    assert not bool(wovf) and not bool(ovf)
    assert ovf.dtype == torch.bool and ovf.ndim == 0
    assert_matches_jax(got, want)
    assert_states_close(got, single(teng, tst, 10), 1e-12)


def test_halo_overflow_flag(halo_crowd):
    """An undersized window raises the flag instead of dropping
    interactions silently."""
    _, _, jst = halo_crowd
    _, teng = _culled(60.0, 16, 64, 4)
    tst = tstate(jst)
    assert P.required_halo(teng, tst, D) > 1
    _, ovf = sharded_run(teng, tst, 4, comm="halo", halo=1)
    assert bool(ovf)


# ---- the flagship (balancing rider) ----


def _setup_flagship(n, stochastic=False, thresh=None, disturb=False,
                    seed=11):
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, 80, n)
    s0[:, 1] = rng.uniform(0, 80, n)
    s0[:, 2] = rng.uniform(-0.2, 0.2, n)
    s0[:, 3] = rng.uniform(4, 6, n)
    st = jmake_state(s0, dtype=np.float64, hist_len=8)
    dst = np.c_[s0[:, 0] + 100, s0[:, 1] + rng.uniform(-5, 5, n),
                np.zeros(n)]
    st = st.replace(dest=jnp.asarray(dst),
                    destqueue=st.destqueue.at[:, 0, :].set(
                        jnp.asarray(dst)))
    kw = {}
    if thresh is not None:
        kw["controlparam_resampling_speedthresh"] = thresh
    if disturb:
        kw.update(p_dist_roll=0.05, T_dist_roll=20.0, p_dist_steer=0.05,
                  T_dist_steer=5.0)
    jp = JBRP.create(stochastic_control_behavior=stochastic, verbose=False,
                     **kw)
    tp = BalancingRiderParams.create(
        stochastic_control_behavior=stochastic, verbose=False, **kw)
    jst = jprepare(JMODELS["balancingrider"], jp, st)
    return (JEngine.create(jp, JMODELS["balancingrider"]),
            Engine.create(tp, MODELS["balancingrider"]), jst)


@pytest.mark.parametrize("stochastic", [False, True])
def test_flagship_matches_jax_and_single_device(stochastic):
    """The balancing rider, exact placement and stochastic (resampling
    and torque disturbances firing heavily, no budget): the draws are
    per uid, so the sharded run equals the single-device one."""
    kw = dict(stochastic=True, thresh=0.05, disturb=True) if stochastic \
        else {}
    jeng, teng, jst = _setup_flagship(4 * D, **kw)
    tst = tstate(jst)
    steps = 25 if stochastic else 30
    want, _ = jax_sharded_run(jeng, jst, steps)
    got, _ = sharded_run(teng, tst, steps)
    assert_matches_jax(got, want)
    ref = single(teng, tst, steps)
    assert_states_close(got, ref, 1e-12, ("s", "dyn_gains", "dyn_x"))
    if stochastic:
        assert not torch.allclose(ref.dyn_gains[:, 5:10],
                                  tst.dyn_gains[:, 5:10])


# ---- scripted agents ----


def _setup_scripted(n=16, t_script=30, culled=False):
    rng = np.random.default_rng(0 if not culled else 3)
    side = 30.0 if not culled else 40.0
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(-side, side, n)
    s0[:, 1] = rng.uniform(-side, side, n)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1, 6, n)
    st = jmake_state(s0, dtype=np.float64)
    for a in range(n):
        st = jset(st, a, (rng.uniform(-50, 50),), (rng.uniform(-50, 50),))
    tr = {}
    for a in ((5, 100) if culled else (3, 9)):
        t = np.zeros((t_script, 4))
        t[:, 0] = s0[a, 0] + 0.08 * np.arange(1, t_script + 1)
        t[:, 1] = s0[a, 1]
        t[:, 3] = 8.0
        tr[a] = t
    cfg = dict(cutoff=1e3, block=16, kb=8, rebuild_every=4)
    jeng = JEngine.create(
        JBP.create(), JMODELS["bicycle2d"],
        scripted=JST.create(n, tr, dtype=jnp.float64),
        neighbors=JNC(backend="xla", **cfg) if culled else None)
    teng = Engine.create(
        BicycleParams.create(), MODELS["bicycle2d"],
        scripted=ScriptedTraj.create(n, tr, torch.float64, DEV),
        neighbors=NeighborConfig(screen=False, **cfg) if culled else None)
    return jeng, teng, st


@pytest.mark.parametrize("comm,culled", [("allgather", False),
                                         ("ring", False),
                                         ("allgather", True)])
def test_scripted_matches_jax_and_single_device(comm, culled):
    """Scripted agents replay uid-indexed tables on whatever shard their
    row lives on, past the script's end (hold); culled, through the
    sorted-resident chunks."""
    jeng, teng, jst = _setup_scripted(128 if culled else 16, 25 if culled
                                      else 30, culled)
    tst = tstate(jst)
    steps = 30 if culled else 40
    want, _ = jax_sharded_run(jeng, jst, steps, comm=comm)
    got, _ = sharded_run(teng, tst, steps, comm=comm)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=0,
                               atol=TOL)
    # JAX's shard_map step leaves out the scripted mask of the destination
    # force (its sharding.py:457; the replay overwrites `s`, but the
    # controller integrates the unmasked force into pid_e and pid_i of
    # the scripted rows); the port's sharded step keeps it, as both
    # packages' single-device steps do: every leaf against JAX's
    # single-device run
    want1, _ = jax.jit(lambda e, s: e.simulate(s, steps, record=False))(
        jeng, jst)
    assert_matches_jax(got, want1)
    ref = single(teng, tst, steps)
    assert_states_close(got, ref, 1e-12 if comm == "allgather" else 1e-9,
                        ("s", "pid_e", "pid_i"))
    rows = (5, 100) if culled else (3, 9)
    for a in rows:                        # held at the script's last point
        assert torch.equal(got.s[a], ref.s[a])


# ---- heterogeneous crowds ----


def _setup_mixed(n=256, side=60.0, cutoff=1e4, kb=24, seed=0,
                 scripted_car=False):
    n_legacy = n // 4
    n_twod = n - n_legacy
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(-side, side, n)
    s0[:, 1] = rng.uniform(-side, side, n)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1, 6, n)
    st = jmake_state(s0, dtype=np.float64, hist_len=16)
    dst = np.c_[rng.uniform(-side, side, n), rng.uniform(-side, side, n)]
    st = st.replace(dest=st.dest.at[:, :2].set(jnp.asarray(dst)),
                    destqueue=st.destqueue.at[:, 0, :2].set(
                        jnp.asarray(dst)))
    tr = None
    if scripted_car:
        t = np.zeros((40, 4))
        t[:, 0] = s0[1, 0] + 8 * 0.01 * np.arange(1, 41)
        t[:, 1] = s0[1, 1]
        t[:, 3] = 8.0
        tr = {1: t}
    cfg = dict(cutoff=cutoff, block=16, kb=kb, rebuild_every=3)
    jme = JMixed.create(
        [("bicycle2d", jas_pop(JBP.create(), n_legacy), n_legacy),
         ("twod", jas_pop(JIPP.create(), n_twod), n_twod)],
        neighbors=JNC(backend="xla", **cfg),
        scripted=None if tr is None else JST.create(n, tr,
                                                    dtype=jnp.float64))
    tme = MixedEngine.create(
        [("bicycle2d", as_population(BicycleParams.create(), n_legacy, DEV),
          n_legacy),
         ("twod", as_population(InvPendulumBicycleParams.create(), n_twod,
                                DEV), n_twod)],
        neighbors=NeighborConfig(screen=False, **cfg),
        scripted=None if tr is None else ScriptedTraj.create(
            n, tr, torch.float64, DEV))
    jst = jprep_groups(jme, st)
    return jme, tme, jst


@pytest.mark.parametrize("comm,scripted_car", [("allgather", False),
                                               ("allgather", True),
                                               ("ring", False)])
def test_mixed_matches_jax_and_single_device(comm, scripted_car):
    """A legacy bicycle2d + twod crowd (per-agent group params, read by
    uid), optionally with a scripted car, 7 steps (two chunks of 3 and a
    remainder): the domain-wide cutoff leaves only summation order."""
    jme, tme, jst = _setup_mixed(scripted_car=scripted_car)
    tst = tstate(jst)
    want, _ = jax_sharded_run(jme, jst, 7, comm=comm)
    got, _ = sharded_run(tme, tst, 7, comm=comm)
    assert_matches_jax(got, want)
    ref = single(tme, tst, 7)
    assert_states_close(got, ref, 1e-12)
    if scripted_car:
        assert torch.equal(got.s[1], ref.s[1])


def test_mixed_halo_matches_single_device():
    """The halo schedule on the mixed crowd: group masks and packed
    family columns ride the uid through the reshard; the MixedEngine
    sorts from original order (not sorted-resident)."""
    n = 512 * D
    _, tme, jst = _setup_mixed(n, side=0.5 * np.sqrt(n / 0.02), cutoff=30.0,
                               kb=64, seed=3)
    tst = tstate(jst)
    h = P.required_halo(tme, tst, D) + 1
    got, ovf = sharded_run(tme, tst, 7, comm="halo", halo=h)
    assert not bool(ovf)
    assert_states_close(got, single(tme, tst, 7), 1e-12)


# ---- the compaction that the CUDA kernels need ----


def test_compacted_hop_table_gives_the_raw_masks_forces():
    """A ring hop's table masked to the resident shard's blocks has holes;
    compacted (valid entries first, in slot order) the plain version's
    forces are bit for bit those of the raw mask, and the compacted rows
    are prefixes with `count` their lengths."""
    _, teng, jst = _setup_culled(512)
    tst = tstate(jst)
    mesh = tmesh()
    shards = P.shard_state(tst, mesh)
    caches = S._neighbor_cache_sharded(teng, mesh, shards)
    perm, nbr, valid = caches[1][:3]
    bl_src = shards[1].n // 16
    lo = 0 * bl_src                   # shard 1's hop 1: shard 0's blocks
    in_hop = valid & (nbr >= lo) & (nbr < lo + bl_src)
    raw_nbr = torch.where(in_hop, nbr - lo, 0)
    holes = (in_hop[:, 1:] & ~in_hop[:, :-1]).any(dim=1)
    assert holes.any()                # some row has a hole before an entry
    c_nbr, c_mask, count = S.compact_table(raw_nbr, in_hop)
    lane = torch.arange(c_mask.shape[1])
    assert torch.equal(c_mask, lane[None, :] < count[:, None].long())
    assert count.dtype == torch.int32
    src, recv = teng.pack_pair_fields(shards[1])
    recv_s = sorted_packs(src, perm)[1]
    block0 = sorted_packs(teng.pack_pair_fields(shards[0])[0],
                          caches[0][0])[0]
    want = teng.pair_kernel_dispatch(raw_nbr, in_hop, block0, recv_s)
    got = teng.pair_kernel_dispatch(c_nbr, c_mask, block0, recv_s, count)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0.1


# ---- what the schedules refuse, as the JAX package refuses it ----


def test_rejections():
    _, teng, _ = _setup(16)
    _, culled_eng, _ = _setup_culled(16 * D)
    mesh = tmesh()

    def max_reduce(fx, fy, mask):
        return (torch.amax(torch.where(mask, fx, 0.0), dim=0),
                torch.amax(torch.where(mask, fy, 0.0), dim=0))

    red = Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                        rep_reduce=max_reduce)
    with pytest.raises(ValueError, match="rep_reduce"):
        P.sharded_step_fn(red, mesh, comm="ring")
    red_culled = Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                               rep_force="twod", rep_reduce=max_reduce,
                               neighbors=culled_eng.neighbors)
    with pytest.raises(ValueError, match="rep_reduce"):
        P.sharded_simulate_fn(red_culled, mesh, 4)
    with pytest.raises(ValueError, match="rep_reduce"):
        P.sharded_simulate_fn(red_culled, mesh, 4, comm="halo")
    P.sharded_step_fn(red, mesh)        # allgather, dense: supported
    custom = Engine.create(
        BicycleParams.create(), MODELS["bicycle2d"],
        rep_force=lambda p, src, recv: rep_tile_twod(p, src, recv),
        neighbors=NeighborConfig(backend="xla", block=16, kb=4))
    with pytest.raises(ValueError, match="custom force tiles"):
        P.sharded_step_fn(custom, mesh)
    # a sharded MixedEngine needs culling, and no binding budget
    me = MixedEngine.create([("bicycle2d", BicycleParams.create(), 16)])
    with pytest.raises(ValueError, match="neighbor culling"):
        P.sharded_step_fn(me, mesh)
    me2 = MixedEngine.create(
        [("balancingrider", BalancingRiderParams.create(
            stochastic_control_behavior=True, resample_budget=8,
            verbose=False), 16)],
        neighbors=NeighborConfig(cutoff=1e4, block=16, kb=1))
    with pytest.raises(ValueError, match="resample_budget"):
        P.sharded_step_fn(me2, mesh)
    # the halo schedule: simulate only, culled only, no records, a halo
    # of at least one block, shards of whole blocks, a window within a
    # strip
    with pytest.raises(ValueError, match="simulate"):
        P.sharded_step_fn(culled_eng, mesh, comm="halo")
    with pytest.raises(ValueError, match="culled"):
        P.sharded_simulate_fn(teng, mesh, 4, comm="halo")
    with pytest.raises(ValueError, match="record"):
        P.sharded_simulate_fn(culled_eng, mesh, 4, record=True, comm="halo")
    with pytest.raises(ValueError, match="halo must be"):
        P.sharded_simulate_fn(culled_eng, mesh, 4, comm="halo", halo=0)
    st = convert.state_from_jax(_spread(8 * D, 1, 30.0), DEV)
    run = P.sharded_simulate_fn(culled_eng, mesh, 4, comm="halo", halo=1)
    with pytest.raises(ValueError, match="divisible by block"):
        run(P.shard_state(st, mesh))
    st = convert.state_from_jax(_spread(16 * D, 1, 30.0), DEV)
    run = P.sharded_simulate_fn(culled_eng, mesh, 4, comm="halo", halo=3)
    with pytest.raises(ValueError, match="wider than a device strip"):
        run(P.shard_state(st, mesh))
    with pytest.raises(ValueError, match="divisible"):
        P.required_halo(culled_eng, st, 3)
    with pytest.raises(ValueError, match="comm must be"):
        P.sharded_step_fn(teng, mesh, comm="tree")
    with pytest.raises(ValueError, match="do not divide"):
        P.shard_state(st, P.make_mesh(3, device=DEV))


def test_mesh_and_state_specs():
    """state_pspecs: per-agent fields on the axis, key and t_glob
    replicated (JAX's specs); shard_state and gather_state round-trip."""
    specs = P.state_pspecs()
    jspecs = JPAR.state_pspecs()
    for f in dataclasses.fields(specs):
        want = getattr(jspecs, f.name)
        assert getattr(specs, f.name) == (tuple(want)[0] if len(want)
                                          else None), f.name
    assert specs.key is None and specs.t_glob is None
    _, _, jst = _setup(4 * D)
    tst = tstate(jst)
    mesh = tmesh()
    shards = P.shard_state(tst, mesh)
    assert len(shards) == D and all(s.n == 4 for s in shards)
    back = P.gather_state(shards, mesh)
    for f in dataclasses.fields(back):
        assert torch.equal(getattr(back, f.name), getattr(tst, f.name))
    # the ring's collective moves shard d's tensor to shard d + 1
    parts = [torch.full((2,), float(d)) for d in range(D)]
    assert [int(t[0]) for t in mesh.ppermute(parts, 1)] == [3, 0, 1, 2]
    assert [int(t[0]) for t in mesh.ppermute(parts, -1)] == [1, 2, 3, 0]
    assert bool(mesh.pmax([torch.tensor(d == 2) for d in range(D)]))
