"""PyTorch port: the per-agent kernels' plain versions (`ops/agent_step.py`)
held to the JAX package at float64 and to the engine's torch chain bit for
bit, on bicycle2d (the straight destination force) and on the twod model
(the spline force and the arrived-freeze), which engines take the fused
route, the route's functional contract, and on the card each kernel
against its plain version (the twod model's instances on the card:
tests/test_torch_agent_step_twod.py).

The JAX package is imported by the tests that compare with it (the `jx`
fixture), so that the card's machine, which cannot import it, runs the
others."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert, external  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.mixed import MixedEngine  # noqa: E402
from cyclistsocialforce_tpu_torch.models import (MODELS,  # noqa: E402
                                                 bicycle2d, bicycle_twod)
from cyclistsocialforce_tpu_torch.ops import agent_step as AS  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (BicycleParams,  # noqa: E402
                                                 as_population)
from cyclistsocialforce_tpu_torch.state import make_state  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
N, NPAD = 500, 512          # a ragged crowd: 12 pad rows in the packs
CFG = dict(cutoff=40.0, block=64, block_src=32, kb=16)
# the per-rider pair columns of each family ("spline": the twod model, its
# spline force and the twod field); their tables are shorter than the
# crowd, so the last uids read the table's last row (clamped)
PER_RIDER = {"twod": ("f_0", "sigma_0"), "legacy": ("p_0", "p_decay"),
             "spline": ("f_0", "sigma_0")}
# the twod model's position ring: its spline looks 1 s (100 steps) back
SPLINE_HIST = 128
TABLE_ROWS = N - 20


@pytest.fixture
def jx():
    """The JAX package's modules and two converters (skips where the
    package cannot be imported)."""
    pytest.importorskip("flax")
    jnp = pytest.importorskip("jax.numpy")
    from cyclistsocialforce_tpu import engine as JE
    from cyclistsocialforce_tpu import make_state as jax_make_state
    from cyclistsocialforce_tpu import params as JP
    from cyclistsocialforce_tpu.models import bicycle2d as jbike
    from cyclistsocialforce_tpu.models import bicycle_twod as jtwod
    from cyclistsocialforce_tpu.ops import forces as JF

    from test_torch_step import close

    def state(st):
        """The JAX AgentState holding a port state's values (its key
        JAX's own)."""
        vals = convert.state_to_numpy(st)
        js = jax_make_state(vals["s"][:, :5], queue_size=st.queue_size,
                            hist_len=st.hist_len, dtype=jnp.float64)
        return js.replace(**{f: jnp.asarray(v) for f, v in vals.items()
                             if f != "key"})

    def params(family, per_rider):
        """`port_params` as JAX BicycleParams."""
        jp = JP.BicycleParams.create()
        return jp.replace(**{f: jnp.asarray(v.numpy()) for f, v in (
            (f, getattr(port_params(family, per_rider), f))
            for f in PER_RIDER[family]) if per_rider})

    def model(family):
        """The JAX model and destination force of `family`."""
        if family == "spline":
            return jtwod, JE.dest_force_spline
        return jbike, JE.dest_force_straight

    return types.SimpleNamespace(JE=JE, JP=JP, jbike=jbike, JF=JF, jnp=jnp,
                                 close=close, state=state, params=params,
                                 model=model)


def crowd(n=N, seed=5, dtype=torch.float64, device=DEV, hist=8):
    """Riders spread over every navigation-FSM state, drawn as
    tests/test_torch_step.py's fsm_state draws them (queue points 0.5-30
    m away, stop flags, pointers, latched braking profiles), with 10% of
    the riders inactive, shuffled uids, pid memories, a position ring of
    `hist` and t_glob = 13."""
    rng = np.random.default_rng(seed)
    q = 4
    s0 = np.zeros((n, 5))
    s0[:, 0:2] = rng.uniform(-20, 20, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.choice([0.0, 0.3, 0.6, 1.5, 2.5, 5.0], n)
    r = rng.choice([0.5, 1.9, 2.1, 4.0, 8.0, 30.0], (n, q))
    ang = rng.uniform(-np.pi, np.pi, (n, q))
    dq = np.stack([s0[:, :1] + r * np.cos(ang), s0[:, 1:2] + r * np.sin(ang),
                   (rng.uniform(size=(n, q)) < 0.5).astype(float)], axis=2)
    nq = rng.integers(1, q + 1, n)
    ptr = rng.integers(0, q, n) % nq
    znav = np.eye(3, dtype=bool)[rng.integers(0, 3, n)]
    latched = np.stack([rng.uniform(0, 6, n), rng.uniform(0.5, 5, n),
                        rng.uniform(0.1, 3, n), rng.integers(0, 50, n)],
                       axis=1)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    st = make_state(s0, queue_size=q, hist_len=hist, dtype=dtype,
                    device=device)
    return st.replace(
        destqueue=t(dq), dest=t(dq[np.arange(n), ptr]),
        nq=t(nq, torch.int32), destpointer=t(ptr, torch.int32),
        znav=t(znav, torch.bool),
        znavparams=t(np.where(znav[:, :1], 0.0, latched)),
        i=t(rng.integers(0, 100, n), torch.int32),
        i_stopsignal=t(rng.integers(0, 100, n), torch.int32),
        d_stopsignal=t(rng.uniform(0, 10, n)),
        active=t(rng.uniform(size=n) >= 0.1, torch.bool),
        uid=t(rng.permutation(n), torch.int32),
        pid_e=t(rng.normal(size=(n, 2))), pid_i=t(rng.normal(size=(n, 2))),
        pos_hist=t(rng.uniform(-20, 20, (n, hist, 2))),
        t_glob=t(13, torch.int32))


def port_params(family, per_rider, device=DEV):
    """The port's BicycleParams with `family`'s PER_RIDER columns per
    rider (float64 tables of TABLE_ROWS rows on `device`)."""
    p = BicycleParams.create()
    if per_rider:
        rng = np.random.default_rng(3)
        p = p.replace(**{f: torch.as_tensor(
            getattr(p, f) * rng.uniform(0.9, 1.1, TABLE_ROWS),
            device=device) for f in PER_RIDER[family]})
    return p


def rep_force(family):
    return None if family == "legacy" else "twod"   # bicycle2d's: legacy


def port_engine(params, family, **kw):
    """bicycle2d with `family`'s field, or for "spline" the twod model."""
    model = bicycle_twod if family == "spline" else bicycle2d
    return TE.Engine.create(params, model, rep_force=rep_force(family),
                            neighbors=TE.NeighborConfig(**{**CFG, **kw}))


def family_crowd(family, n=N, **kw):
    """`crowd`, with the ring of the twod model's lookback for "spline"."""
    return crowd(n, hist=SPLINE_HIST if family == "spline" else 8, **kw)


@pytest.mark.parametrize("family", ["twod", "legacy", "spline"])
@pytest.mark.parametrize("per_rider", [False, True])
def test_agent_pre_ref_matches_jax(jx, family, per_rider):
    """Destination force, FSM fields (an inactive row's held, as JAX's
    finish_step holds them) and both packs (pad rows included) against
    the JAX package's dest_force_straight (the twod model: its
    dest_force_spline) and pack_pair_fields."""
    st = family_crowd(family)
    jst, jp = jx.state(st), jx.params(family, per_rider)
    jmodel, jdest = jx.model(family)
    jfx, jfy, jnew = jdest(jp, jst)
    jeng = jx.JE.Engine.create(jp, jmodel, rep_force=rep_force(family))
    jsrc, jrecv = jeng.pack_pair_fields(jnew, NPAD)
    pre = AS.agent_pre_ref(
        port_engine(port_params(family, per_rider), family), st, NPAD)
    jx.close(pre.fdx, jfx, "fdx")
    jx.close(pre.fdy, jfy, "fdy")
    act = np.asarray(jst.active)
    assert not act.all()
    for f in ("dest", "destpointer", "znav", "znavparams", "i_stopsignal",
              "d_stopsignal"):
        new, old = np.asarray(getattr(jnew, f)), np.asarray(getattr(jst, f))
        held = np.where(act.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
        jx.close(getattr(pre.state, f), held, f)
    jx.close(pre.src_pack, jsrc, "src_pack")
    jx.close(pre.recv_pack, jrecv, "recv_pack")
    if per_rider:
        # a uid past the table reads its last row
        col, table = ((7, 1.0 / jp.p_decay) if family == "legacy"
                      else (4, jp.f_0))
        past = (st.uid >= TABLE_ROWS) & st.active
        assert past.any()
        np.testing.assert_allclose(pre.src_pack[:N][past, col].numpy(),
                                   float(table[-1]), rtol=1e-15)


@pytest.mark.parametrize("family", ["twod", "spline"])
def test_agent_post_ref_matches_jax(jx, family):
    """Clamp, the model's step (bicycle2d's; the twod model's with its
    arrived-freeze) and bookkeeping (inactive rows held, the counters, the
    ring slot) against the JAX package."""
    rng = np.random.default_rng(4)
    st = family_crowd(family, seed=6)
    jst, jp = jx.state(st), jx.JP.BicycleParams.create()
    jmodel, jdest = jx.model(family)
    jfx, jfy, jnew = jdest(jp, jst)
    frx = rng.normal(size=N) * 8
    fry = rng.normal(size=N) * 8
    wfx, wfy = jx.JF.clamp_add_dest(jx.jnp.asarray(frx), jx.jnp.asarray(fry),
                                    jfx, jfy)
    jeng = jx.JE.Engine.create(jp, jmodel, rep_force="twod")
    want = jeng.finish_step(jst, jmodel.step(jp, jnew, wfx, wfy))
    eng = port_engine(BicycleParams.create(), family)
    pre = AS.agent_pre_ref(eng, st, NPAD)
    got, fx, fy = AS.agent_post_ref(eng, st, pre, torch.from_numpy(frx),
                                    torch.from_numpy(fry))
    jx.close(fx, wfx, "fx")
    jx.close(fy, wfy, "fy")
    for f, v in convert.state_to_numpy(got).items():
        if f != "key":
            jx.close(v, getattr(want, f), f)
    assert (~got.active).any()
    if family == "spline":
        # active riders that arrived: held still, speed, steer, roll zero
        frozen = (pre.state.znav[:, 2] & st.active).numpy()
        assert frozen.any()
        np.testing.assert_array_equal(got.s[frozen][:, 3:6].numpy(), 0.0)
        np.testing.assert_array_equal(got.pid_e[frozen].numpy(),
                                      st.pid_e[frozen].numpy())


@pytest.mark.parametrize("family", ["twod", "legacy", "spline"])
@pytest.mark.parametrize("presorted", [False, True])
def test_fused_step_bit_equal_to_torch_chain(family, presorted):
    """The fused route (the two plain versions around the pair stage) is
    the engine's torch chain bit for bit in float32, sorted-resident and
    not (ragged, with pad rows in the packs)."""
    n = NPAD if presorted else N
    eng = port_engine(port_params(family, per_rider=True), family)
    st = family_crowd(family, n, dtype=torch.float32)
    cache = eng.neighbor_cache(st)
    if presorted:
        st = TE.permute_state(st, cache[0])
    want, wfx, wfy = eng.step_with_forces(st, cache, presorted)
    got, gfx, gfy = eng.fused_step(st, eng.kernels_on(DEV, st.hist_len),
                                   cache, presorted)
    assert torch.equal(gfx, wfx) and torch.equal(gfy, wfy)
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.s.dtype == torch.float32


def test_fused_form_table():
    """Which engines take the per-agent kernels (on the card): bicycle2d
    with the straight destination force and the twod model with its
    spline force, a culled named field, shared navigation and model
    parameters (for the spline t_s, so one lookback, and g), per-rider
    pair columns allowed; the twod model's ring must hold its lookback.
    The engine-side rule (`Engine.kernels_on`) is asked for the CPU."""
    cpu = torch.device("cpu")
    base = BicycleParams.create()
    pop = as_population(base, 64, DEV)
    cfg = TE.NeighborConfig(**CFG)
    kaths = external.KATHS_VELOANISO_PARAMS

    def bike(params=base, **kw):
        return TE.Engine.create(params, MODELS["bicycle2d"], **{
            "rep_force": "twod", "neighbors": cfg, **kw})

    def twod(params=base, **kw):
        return TE.Engine.create(params, MODELS["twod"],
                                **{"neighbors": cfg, **kw})

    table = {
        "twod K1": (bike(), True),
        "twod K2": (bike(neighbors=TE.NeighborConfig(
            **CFG, backend="pallas_unrolled")), True),
        "twod K3": (bike(neighbors=TE.NeighborConfig(
            cutoff=40.0, block=64, kb=16, backend="pallas_db")), True),
        "legacy": (bike(rep_force=None), True),
        "direct": (bike(dest_force="direct"), True),
        "per-rider pair columns": (bike(base.replace(
            f_0=pop.f_0, sigma_0=pop.sigma_0.float())), True),
        "per-rider navigation": (bike(base.replace(
            v_desired_default=pop.v_desired_default)), False),
        "per-rider model": (bike(base.replace(k_p_v=pop.k_p_v)), False),
        "hm": (bike(dest_force="hm"), False),
        "dense": (bike(neighbors=None), False),
        "road": (bike(road=TE.RoadElements(*(torch.zeros(k) for k in (
            (1, 2), 1, 1, 1)))), False),
        "scripted": (bike(scripted=TE.ScriptedTraj.create(
            64, {0: np.zeros((4, 4))}, device=DEV)), False),
        "combine_forces hook": (bike(
            combine_forces=lambda a, b, c, d: (a + c, b + d)), False),
        "twod model": (twod(), True),
        "twod model, legacy field": (twod(rep_force="legacy"), True),
        "twod model, per-rider pair columns": (twod(base.replace(
            f_0=pop.f_0, sigma_0=pop.sigma_0.float())), True),
        "twod model, per-rider t_s": (twod(base.replace(t_s=pop.t_s)),
                                      False),
        "twod model, per-rider g": (twod(base.replace(g=pop.g)), False),
        "twod model, road": (twod(road=TE.RoadElements(*(torch.zeros(k) for k
                                                         in ((1, 2), 1, 1,
                                                             1)))), False),
        "twod model, combine_forces hook": (twod(
            combine_forces=lambda a, b, c, d: (a + c, b + d)), False),
        "twod model, straight force": (twod(dest_force="straight"), False),
        "twod model, dense": (twod(neighbors=None), False),
        "bicycle2d, spline force": (bike(dest_force="spline"), False),
        "invpendulum": (TE.Engine.create(
            base, MODELS["invpendulum"], neighbors=cfg), False),
        "kaths": (TE.Engine.create(BicycleParams.create(
            rep_force=kaths, dest_force=kaths), external,
            neighbors=TE.NeighborConfig(**CFG, backend="xla")), False),
        "mixed": (MixedEngine.create([("bicycle2d", base, 32),
                                      ("twod", base, 32)],
                                     neighbors=cfg), False),
    }
    # the twod model's ring holds its 1 s lookback (100 steps) and the
    # step before it; bicycle2d reads no lookback (every other case is
    # asked with a ring of SPLINE_HIST slots)
    lookback = TE.spline_lookback(base)
    assert lookback == 100
    rings = {"twod model, ring of 8": (twod(), 8, False),
             "twod model, ring of the lookback": (twod(), lookback, False),
             "twod model, ring of the lookback and one": (
                 twod(), lookback + 1, True),
             "bicycle2d, ring of 8": (bike(), 8, True)}
    table.update({name: (eng, want) for name, (eng, _, want) in
                  rings.items()})
    got = {name: eng.kernels_on(cpu, rings[name][1] if name in rings
                                else SPLINE_HIST)
           for name, (eng, _) in table.items()}
    assert {name: k is not None for name, k in got.items()} == {
        name: want for name, (_, want) in table.items()}
    # the kernels are the ones the model declares
    assert got["twod K1"] == bicycle2d.agent_kernels(base)
    assert got["twod model"] == bicycle_twod.agent_kernels(base)
    assert (got["twod model"].dest, got["twod model"].post) == (
        "spline", "agent_post_twod")
    # a per-rider column on another device than the state's keeps the
    # torch chain; so does any state on the CPU
    assert table["per-rider pair columns"][0].kernels_on("meta", 8) is None
    assert bike().agent_kernels(crowd(64, dtype=torch.float32)) is None


def test_fused_step_contract():
    """The step leaves its argument untouched; the fields no step changes
    are the argument's own tensors, the others fresh ones."""
    eng = port_engine(BicycleParams.create(), "twod")
    st = crowd(dtype=torch.float32)
    keep = {f: getattr(st, f).clone() for f in TE._STATE_FIELDS}
    new, _, _ = eng.fused_step(st, eng.kernels_on(DEV, st.hist_len))
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(st, f), keep[f]), f
        shared = getattr(new, f) is getattr(st, f)
        assert shared == (f in AS.UNCHANGED), f
        if not shared:
            assert (getattr(new, f).untyped_storage().data_ptr()
                    != getattr(st, f).untyped_storage().data_ptr()), f
    assert not torch.equal(new.s, st.s)
    assert int(new.t_glob) == int(st.t_glob) + 1


def test_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors each wrapper is its plain version bit for bit and
    counts no launch."""
    AS.agent_pre.launches = AS.agent_post.launches = 0
    eng = port_engine(port_params("legacy", True), "legacy")
    st = crowd(dtype=torch.float32)
    pre, pre_r = AS.agent_pre(eng, st, NPAD), AS.agent_pre_ref(eng, st, NPAD)
    for a, b in zip(pre, pre_r):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    frx = torch.linspace(-3, 3, N)
    post = AS.agent_post(eng, st, pre, frx, -frx)
    post_r = AS.agent_post_ref(eng, st, pre, frx, -frx)
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(post[0], f), getattr(post_r[0], f)), f
    assert torch.equal(post[1], post_r[1]) and torch.equal(post[2], post_r[2])
    assert AS.agent_pre.launches == AS.agent_post.launches == 0


def test_per_agent_navigation_params_follow_rows_in_both_packages(jx):
    """Known reference-side issue: the JAX package reads per-agent
    navigation (and model) parameters by ROW, while the pair columns go by
    uid; under the sorted-resident permutation a row then steers with
    another rider's parameters. The port keeps that behaviour: on a
    permuted crowd its destination force equals JAX's, which is not the
    unpermuted force permuted."""
    rng = np.random.default_rng(12)
    st = crowd(seed=7)
    vdd = rng.uniform(3, 7, N)
    perm = rng.permutation(N)
    jst = jx.state(st)
    jp = jx.JP.BicycleParams.create().replace(
        v_desired_default=jx.jnp.asarray(vdd))
    jfx, _, _ = jx.JE.dest_force_straight(jp, jst)
    jfx_p, _, _ = jx.JE.dest_force_straight(
        jp, jx.JE.permute_state(jst, jx.jnp.asarray(perm)))
    tfx_p, _, _ = TE.dest_force_straight(
        BicycleParams.create().replace(
            v_desired_default=torch.from_numpy(vdd)),
        TE.permute_state(st, torch.from_numpy(perm)))
    jx.close(tfx_p, jfx_p, "fx of the permuted crowd")
    cruising = st.znav[perm, 0].numpy() & (np.asarray(jfx)[perm] != 0)
    assert cruising.any()
    assert not np.allclose(np.asarray(jfx_p)[cruising],
                           np.asarray(jfx)[perm][cruising])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the per-agent kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["twod", "legacy"])
def test_cuda_agent_kernels_match_plain(cuda_device, family):
    """On the card each kernel equals its plain version bit for bit on a
    4,000-rider crowd in every FSM state with per-rider pair columns (its
    packs padded to 4,032 rows, the pad rows compared too), is counted
    once per call, and keeps the step's functional contract."""
    n = 4000
    eng = port_engine(port_params(family, True, cuda_device), family)
    st = crowd(n, dtype=torch.float32, device=cuda_device)
    npad = eng.pair_rows(n)
    assert npad > n and eng.agent_kernels(st) is not None
    keep = {f: getattr(st, f).clone() for f in TE._STATE_FIELDS}
    before = AS.agent_pre.launches, AS.agent_post.launches
    pre = AS.agent_pre(eng, st, npad)
    pre_r = AS.agent_pre_ref(eng, st, npad)
    for f in ("fdx", "fdy", "src_pack", "recv_pack"):
        assert torch.equal(getattr(pre, f), getattr(pre_r, f)), f
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(pre.state, f.name),
                           getattr(pre_r.state, f.name)), f.name
    frx, fry = eng.pair_stage(st, pre_r.src_pack, pre_r.recv_pack)
    got = AS.agent_post(eng, st, pre_r, frx, fry)
    want = AS.agent_post_ref(eng, st, pre_r, frx, fry)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
        assert torch.equal(getattr(st, f), keep[f]), f
        assert (getattr(got[0], f) is getattr(st, f)) == (f in AS.UNCHANGED)
    assert (AS.agent_pre.launches, AS.agent_post.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_step_takes_the_fused_route(cuda_device):
    """Engine.step on a float32 CUDA state goes through both kernels; a
    float64 state keeps the torch chain."""
    eng = port_engine(BicycleParams.create(), "twod")
    before = AS.agent_pre.launches, AS.agent_post.launches
    eng.step(crowd(dtype=torch.float32, device=cuda_device))
    eng.step(crowd(device=cuda_device))
    torch.cuda.synchronize()
    assert (AS.agent_pre.launches, AS.agent_post.launches) == (
        before[0] + 1, before[1] + 1)
