"""PyTorch port: the Kaths (2023) external model (`external.py`) through
the engine's hooks (callable `dest_force`/`rep_force`, `rep_reduce`,
`combine_forces`, the model's `step`), the dense stage's reduction hook
and the generic culled path (`repulsive_sum_neighbors_generic`, backend
"xla"), held to the JAX package.

- golden `kaths_single.npz` at tests/test_parity_walk_kaths.py's bars:
  1e-6 m in position, 1e-8 in speed and in both force channels over
  1,200 steps;
- the six cases of tests/test_external.py on the port, the culled path
  against the dense one and the refusal of a kernel backend for a custom
  tile among them;
- 256 riders in float64 through both packages, dense and culled, 50
  steps at 1e-9;
- the parameter dicts through `convert.params_from_jax`, `as_population`
  and equality.

The card's case (graphed against eager on the generic path) is marked
`cuda` and skips without a card.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch import external  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, as_population)
from cyclistsocialforce_tpu_torch.state import (make_state,  # noqa: E402
                                                set_destinations)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
KATHS = external.KATHS_VELOANISO_PARAMS
CROWD_N, CROWD_STEPS = 256, 50


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax
    import parity_common

    from cyclistsocialforce_tpu import engine, external as jext, make_state
    from cyclistsocialforce_tpu import params
    from cyclistsocialforce_tpu.state import set_destinations as jset

    return types.SimpleNamespace(jax=jax, JE=engine, JP=params, ext=jext,
                                 make_state=make_state, set_destinations=jset,
                                 pc=parity_common)


def kaths_params(n, v_desired=4.0, device=DEV):
    return as_population(BicycleParams.create(
        v_desired_default=v_desired, rep_force=KATHS, dest_force=KATHS), n,
        device=device)


def kaths_engine(s0, dests, v_desired=4.0, neighbors=None, device=DEV,
                 dtype=torch.float64):
    """The port's Kaths engine and state (tests/test_external.py's
    `_engine`): each rider rides toward its one destination."""
    st = make_state(np.asarray(s0, dtype=np.float64), dtype=dtype,
                    device=device)
    for a, (dx, dy) in enumerate(dests):
        st = set_destinations(st, a, dx, dy, reset=True)
    eng = TE.Engine.create(kaths_params(st.n, v_desired, device), external,
                           neighbors=neighbors)
    return eng, st


def jax_kaths_engine(jx, s0, dests, v_desired=4.0, neighbors=None):
    st = jx.make_state(np.asarray(s0, dtype=np.float64), dtype=np.float64)
    for a, (dx, dy) in enumerate(dests):
        st = jx.set_destinations(st, a, dx, dy, reset=True)
    p = jx.JP.as_population(jx.JP.BicycleParams.create(
        v_desired_default=v_desired, rep_force=KATHS, dest_force=KATHS),
        st.n)
    return jx.JE.Engine.create(p, jx.ext, neighbors=neighbors), st


def random_crowd(n, seed, side=60.0):
    """tests/test_external.py's culled crowd: uniform in a side x side
    square, headings within 0.5 rad of +x, 2-5 m/s, each rider's
    destination 50 m ahead."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 4))
    s0[:, 0] = rng.uniform(0, side, n)
    s0[:, 1] = rng.uniform(0, side, n)
    s0[:, 2] = rng.uniform(-0.5, 0.5, n)
    s0[:, 3] = rng.uniform(2, 5, n)
    dests = [((float(s0[a, 0] + 50),), (float(s0[a, 1]),))
             for a in range(n)]
    return s0, dests


# ---- the golden and tests/test_external.py's cases ---------------------------


def test_kaths_single_agent_golden():
    """Golden kaths_single.npz (tests/test_parity_walk_kaths.py): the
    Kaths model driven by its own destination force, 1,200 steps."""
    import parity_common

    golden = parity_common.load_golden("kaths_single.npz")
    eng, st = kaths_engine([[0.0, 0.0, 0.1, 2.0]], [((30, 30, 30),
                                                     (5, 20, 21))])
    assert eng.pair_family == "custom"
    assert eng.combine_forces is external.combine_forces_kaths
    n_steps = 1200
    _, (traj, fv, ft) = eng.simulate(st, n_steps, record_forces=True)
    traj, fv, ft = traj.numpy(), fv.numpy(), ft.numpy()
    ref = golden["traj_0"]
    perr = np.max(np.hypot(traj[:, 0, 0] - ref[0, 1:n_steps + 1],
                           traj[:, 0, 1] - ref[1, 1:n_steps + 1]))
    assert perr < 1e-6, f"max position err {perr}"
    np.testing.assert_allclose(traj[:, 0, 3], ref[3, 1:n_steps + 1],
                               atol=1e-8)
    np.testing.assert_allclose(fv[:, 0], golden["forces_0"][0, 1:n_steps + 1],
                               atol=1e-8)
    np.testing.assert_allclose(ft[:, 0], golden["forces_0"][1, 1:n_steps + 1],
                               atol=1e-8)


@pytest.mark.parametrize("psi, dest_y", [(0.2, 0.0), (-0.3, 5.0),
                                         (0.0, -4.0)])
def test_dest_force_relaxes_speed_and_heading(jx, psi, dest_y):
    """(Fv, Ft) = ((v_des - v) / T_vb, (arctan(dy/dx) - psi) / T_tb), as
    the JAX package computes them."""
    s0, dests = [[0.0, 0.0, psi, 2.0]], [((20.0,), (dest_y,))]
    eng, st = kaths_engine(s0, dests)
    fv, ft, _ = external.dest_force_kaths(eng.params, st)
    np.testing.assert_allclose(float(fv[0]), (4.0 - 2.0) / KATHS["T_vb"],
                               rtol=1e-15)
    np.testing.assert_allclose(
        float(ft[0]), (np.arctan(dest_y / 20.0) - psi) / KATHS["T_tb"],
        rtol=1e-14)
    jeng, jst = jax_kaths_engine(jx, s0, dests)
    jfv, jft, _ = jx.ext.dest_force_kaths(jeng.params, jst)
    assert float(fv[0]) == float(jfv[0]) and float(ft[0]) == float(jft[0])


def test_dest_bearing_is_arctan_not_atan2():
    """A destination straight behind (dx < 0, dy = 0) gives bearing 0 by
    arctan(dy/dx), where atan2 would give pi; dx = 0 gives +-pi/2."""
    eng, st = kaths_engine([[0.0, 0.0, 0.0, 2.0], [0.0, 0.0, 0.0, 2.0]],
                           [((-20.0,), (0.0,)), ((0.0,), (5.0,))])
    _, ft, _ = external.dest_force_kaths(eng.params, st)
    assert float(ft[0]) == 0.0
    np.testing.assert_allclose(float(ft[1]), (np.pi / 2) / KATHS["T_tb"],
                               rtol=1e-15)


def test_single_agent_converges_to_desired_speed_and_bearing():
    eng, st = kaths_engine([[0.0, -3.0, 0.0, 2.0]], [((40.0,), (0.0,))])
    _, traj = eng.simulate(st, 800)
    traj = traj.numpy()
    assert np.all(np.isfinite(traj))
    assert abs(traj[-1, 0, 3] - 4.0) < 0.05          # v -> v_desired
    dpsi = abs(traj[-1, 0, 2] - np.arctan(
        (0.0 - traj[-1, 0, 1]) / (40.0 - traj[-1, 0, 0])))
    assert dpsi < 0.05


def test_repulsion_turns_away_from_neighbor():
    """A rider with a close neighbour ahead-left turns right and rides
    slower than alone."""
    s0_pair = [[0.0, 0.0, 0.0, 4.0], [4.0, 0.8, 0.0, 4.0]]
    eng, st = kaths_engine(s0_pair, [((40.0,), (0.0,)), ((44.0,), (0.8,))])
    _, traj = eng.simulate(st, 200)
    eng1, st1 = kaths_engine(s0_pair[:1], [((40.0,), (0.0,))])
    _, solo = eng1.simulate(st1, 200)
    traj, solo = traj.numpy(), solo.numpy()
    assert np.all(np.isfinite(traj))
    assert traj[-1, 0, 1] < solo[-1, 0, 1] - 1e-3
    assert traj[-1, 0, 3] < solo[-1, 0, 3]


def test_anisotropy_front_vs_back(jx):
    """The distorted distance is signed along the receiver's heading: the
    same lateral offset repels less ahead than behind. The tile equals
    the JAX package's."""
    import jax.numpy as jnp

    p = BicycleParams.create(v_desired_default=4.0, rep_force=KATHS,
                             dest_force=KATHS)
    jp = jx.JP.BicycleParams.create(v_desired_default=4.0, rep_force=KATHS,
                                    dest_force=KATHS)

    def fv_from(src_xy):
        src = [[src_xy[0]], [src_xy[1]], [0.0], [4.0]]
        recv = [[0.0], [0.0], [0.0], [4.0]]
        fv, ft = external.rep_tile_kaths(
            p, tuple(torch.tensor(a, dtype=torch.float64) for a in src),
            tuple(torch.tensor(a, dtype=torch.float64) for a in recv))
        jfv, jft = jx.ext.rep_tile_kaths(
            jp, tuple(jnp.asarray(a) for a in src),
            tuple(jnp.asarray(a) for a in recv))
        np.testing.assert_allclose(fv.numpy(), np.asarray(jfv), rtol=1e-15)
        np.testing.assert_allclose(ft.numpy(), np.asarray(jft), rtol=1e-15)
        return float(fv[0, 0])

    ahead = fv_from((3.0, 0.5))
    behind = fv_from((-3.0, 0.5))
    assert behind < ahead < 0


def test_kaths_culled_matches_dense():
    """The generic culled path (custom tile, min-reduced Fv, per receiver
    block) reproduces the dense forces with a cutoff that covers the
    domain, and the culled run follows the dense one."""
    n = 96
    s0, dests = random_crowd(n, 7)
    eng, st = kaths_engine(s0, dests)
    frv_d, frt_d = eng.repulsive_sum(st)
    eng_c = TE.Engine.create(eng.params, external,
                             neighbors=TE.NeighborConfig(
                                 cutoff=1e3, block=16, kb=6, backend="xla"))
    assert eng_c.pair_family == "custom"
    frv_c, frt_c = eng_c.repulsive_sum_neighbors(st)
    np.testing.assert_allclose(frv_c.numpy(), frv_d.numpy(), atol=1e-9)
    np.testing.assert_allclose(frt_c.numpy(), frt_d.numpy(), atol=1e-9)
    d_fin, _ = eng.simulate(st, 20, record=False)
    c_fin, _ = eng_c.simulate(st, 20, record=False)
    np.testing.assert_allclose(c_fin.s.numpy(), d_fin.s.numpy(), atol=1e-8)


def test_kaths_culled_rejects_pallas_backend():
    """A custom tile is culled only by the generic path; a named field is
    refused the generic path (its pairs go through a kernel)."""
    eng, _ = kaths_engine([[0.0, 0.0, 0.0, 4.0], [4.0, 0.8, 0.0, 4.0]],
                          [((40.0,), (0.0,)), ((44.0,), (0.8,))])
    for backend in TE.KERNEL_BACKENDS:
        with pytest.raises(ValueError, match="custom force tiles"):
            TE.Engine.create(eng.params, external,
                             neighbors=TE.NeighborConfig(
                                 cutoff=100.0, block=16, kb=4,
                                 backend=backend))
    for rep in ("twod", "legacy"):
        with pytest.raises(ValueError, match="plain version"):
            TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                             rep_force=rep, neighbors=TE.NeighborConfig(
                                 backend="xla"))


# ---- against the JAX package -------------------------------------------------


def generic_config(**kw):
    cfg = dict(cutoff=30.0, block=32, block_src=16, kb=12, backend="xla",
               rebuild_every=10)
    return {**cfg, **kw}


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
def test_crowd_matches_jax(jx, culled):
    """256 Kaths riders in float64, 50 steps, through both packages:
    dense, and culled through the generic path (two table rebuilds and
    the steps between them), at 1e-9 m."""
    s0, dests = random_crowd(CROWD_N, 11, side=200.0)
    cfg = generic_config() if culled else None
    eng, st = kaths_engine(s0, dests, neighbors=(
        TE.NeighborConfig(**cfg) if culled else None))
    jeng, jst = jax_kaths_engine(jx, s0, dests, neighbors=(
        jx.JE.NeighborConfig(**cfg) if culled else None))
    if culled:
        assert not eng.neighbor_cache(st)[3].any()
    fin, traj = eng.simulate(st, CROWD_STEPS)
    jfin, jtraj = jx.jax.jit(lambda e, s: e.simulate(s, CROWD_STEPS))(
        jeng, jst)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-9)
    np.testing.assert_allclose(fin.s.numpy(), np.asarray(jfin.s),
                               atol=1e-9)
    assert np.abs(fin.s.numpy()[:, :2] - s0[:, :2]).max() > 0.5


@pytest.mark.parametrize("blocks_per_call", [1, 3, 1000])
def test_generic_forces_match_jax_in_any_chunking(jx, blocks_per_call,
                                                  monkeypatch):
    """The generic path's forces equal the JAX package's for any number
    of receiver blocks per vmapped call (the call's tile budget), on a
    population that is not a multiple of the block (pad rows)."""
    n = 200
    s0, dests = random_crowd(n, 5, side=70.0)
    cfg = generic_config(kb=16)
    eng, st = kaths_engine(s0, dests, neighbors=TE.NeighborConfig(**cfg))
    per_block = cfg["kb"] * cfg["block_src"] * cfg["block"]
    monkeypatch.setattr(TE, "GENERIC_TILE_PAIRS",
                        blocks_per_call * per_block)
    assert eng.generic_blocks_per_call() == blocks_per_call
    jeng, jst = jax_kaths_engine(jx, s0, dests,
                                 neighbors=jx.JE.NeighborConfig(**cfg))
    got = eng.repulsive_sum_neighbors(st)
    want = jeng.repulsive_sum_neighbors(jst)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12)


def test_param_dicts_through_convert_and_as_population(jx):
    """`rep_force` and `dest_force` are plain dicts of floats in the port:
    `as_population` carries them as they are, `convert.params_from_jax`
    reads JAX's (whose `as_population` broadcast them per agent) back to
    the same floats, and equal dicts compare equal."""
    mine = dict(KATHS, T_vb=1.7)
    p = BicycleParams.create(rep_force=mine, dest_force={"T_tb": 0.9})
    assert p.rep_force == mine and p.dest_force == {"T_tb": 0.9}
    assert p.rep_force is not mine
    assert all(isinstance(v, float) for v in p.rep_force.values())
    pop = as_population(p, 5, device=DEV)
    assert pop.rep_force == p.rep_force and pop.dest_force == p.dest_force
    assert BicycleParams.create().rep_force == {}
    assert (BicycleParams.create(rep_force=mine)
            == BicycleParams.create(rep_force=dict(mine)))
    assert (BicycleParams.create(rep_force=mine)
            != BicycleParams.create(rep_force=KATHS))
    jp = jx.JP.as_population(jx.JP.BicycleParams.create(
        rep_force=mine, dest_force={"T_tb": 0.9}), 5)
    conv = convert.params_from_jax(jp, DEV)
    assert conv.rep_force == mine and conv.dest_force == {"T_tb": 0.9}
    assert external._kp(conv, "T_vb") == 1.7
    assert external._kp(conv, "T_tb") == 0.9
    with pytest.raises(ValueError, match="differs between agents"):
        BicycleParams.create(rep_force={"T_vb": np.array([1.0, 2.0])})


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_generic_graph_equals_eager(cuda_device):
    """The generic culled path on the card: the graphed run equals the
    eager loop bit for bit (no pair kernel is launched), and the float64
    run on the card follows the CPU's."""
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    s0, dests = random_crowd(1024, 3, side=220.0)
    cfg = TE.NeighborConfig(**generic_config(block=128, block_src=64,
                                             kb=16))
    eng, st = kaths_engine(s0, dests, neighbors=cfg, device=cuda_device,
                           dtype=torch.float32)
    assert not eng.neighbor_cache(st)[3].any()
    want = eng.simulate(st, 25, record=False, graph=False)[0]
    PF.reset_launches()
    got = eng.simulate(st, 25, record=False, graph=True)[0]
    torch.cuda.synchronize()
    assert PF.launch_counts() == (0,) * len(PF.KERNELS)
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    eng64, st64 = kaths_engine(s0, dests, neighbors=cfg,
                               device=cuda_device)
    cpu, cst = kaths_engine(s0, dests, neighbors=cfg)
    np.testing.assert_allclose(
        eng64.simulate(st64, 25, record=False)[0].s.cpu().numpy(),
        cpu.simulate(cst, 25, record=False)[0].s.numpy(), atol=1e-9)


def test_mixed_engine_group_takes_a_callable_dest_force():
    """A MixedEngine group whose model names its destination force by a
    callable (as the JAX package's MixedEngine takes it) runs as the one
    that names it by its registry name."""
    from cyclistsocialforce_tpu_torch.mixed import MixedEngine
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    st = build_population(64, 0.02, 8, None, torch.float64, DEV)
    named = MODELS["bicycle2d"]
    called = types.SimpleNamespace(
        step=named.step, DEST_FORCE=TE.dest_force_straight,
        REP_FORCE="legacy", STATE_WIDTHS=named.STATE_WIDTHS)
    p = BicycleParams.create()
    want = MixedEngine.create([(named, p, 32), (named, p, 32)]).step(st)
    got = MixedEngine.create([(named, p, 32), (called, p, 32)]).step(st)
    assert torch.equal(got.s, want.s)
