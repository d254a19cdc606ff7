"""PyTorch port: the twod model's per-agent kernels on the card, agent_pre's
spline instance (the spline destination force, its fallback and the
packs) and agent_post's twod instance (the arrived-freeze, the ring copied
a warp at a time), in `csrc/agent_step.cu`.

All tests here need a card (`cuda` marker) and skip without one; the
plain versions and the rule that picks the kernels are tested on the CPU
in tests/test_torch_agent_step.py. On a crowd on routes of up to four
waypoints, some ending at a stop, some riders already arrived and some
inactive: the fused route against the engine's torch chain bit for bit
over 300 eager steps (the ring wraps past its 128 slots); a graphed
100-step run against the eager one; the kernels against their plain versions at
ragged sizes; and a ring shorter than the lookback keeping the chain.

No test here imports the JAX package: the torch chain is the reference
(tests/test_torch_twod.py holds it to JAX)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import agent_step as AS  # noqa: E402
from cyclistsocialforce_tpu_torch.params import BicycleParams  # noqa: E402
from cyclistsocialforce_tpu_torch.state import make_state  # noqa: E402

# the benchmark's twod culling (benchmark/configs/twod_spline.json)
CFG = dict(cutoff=50.0, block=128, block_src=64, kb=24, rebuild_every=20,
           screen=False)
HIST = 128                  # the ring: the spline looks 100 steps back
RIDERS = 8000
STEPS = 300                 # past the ring's 128 slots, twice
GRAPH_STEPS = 100
DENSITY = 0.02
SPACING = 6.0               # m between a rider's waypoints
ARRIVED, STOPS, INACTIVE = 0.05, 0.3, 0.03
KERNELS = (AS.agent_pre, AS.agent_post, AS.agent_post_whipple)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the per-agent kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def twod_engine():
    return TE.Engine.create(BicycleParams.create(), MODELS["twod"],
                            neighbors=TE.NeighborConfig(**CFG))


def routes_crowd(n, device, hist=HIST, seed=7):
    """n riders at DENSITY, 1-6 m/s, each on a route of 1-4 waypoints
    SPACING apart along its heading (up to 1.5 m aside), the last a stop
    for STOPS of them; ARRIVED of them already arrived at a stop half a
    metre ahead and still, INACTIVE of them inactive; t_glob 0, so the
    first step is every rider's step 0."""
    rng = np.random.default_rng(seed)
    side = 0.5 * np.sqrt(n / DENSITY)
    s0 = np.zeros((n, 5))
    s0[:, :2] = rng.uniform(-side, side, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1.0, 6.0, n)
    nq = rng.integers(1, 5, n)
    along = SPACING * np.arange(1, 5)[None, :]
    off = rng.uniform(-1.5, 1.5, (n, 4))
    c, s = np.cos(s0[:, 2:3]), np.sin(s0[:, 2:3])
    dq = np.zeros((n, 16, 3))
    dq[:, :4, 0] = s0[:, :1] + along * c - off * s
    dq[:, :4, 1] = s0[:, 1:2] + along * s + off * c
    dq[np.arange(n), nq - 1, 2] = rng.uniform(size=n) < STOPS
    ptr = np.zeros(n, dtype=np.int64)
    znav = np.zeros((n, 3), dtype=bool)
    znav[:, 0] = True
    arrived = rng.uniform(size=n) < ARRIVED
    ptr[arrived] = nq[arrived] - 1
    last = dq[arrived, ptr[arrived]]
    last[:, :2] = s0[arrived, :2] + 0.5 * np.concatenate(
        [c[arrived], s[arrived]], axis=1)
    last[:, 2] = 1.0
    dq[arrived, ptr[arrived]] = last
    s0[arrived, 3] = 0.0
    znav[arrived] = [False, False, True]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    st = make_state(s0, queue_size=16, hist_len=hist, dtype=torch.float32,
                    model=MODELS["twod"], device=device)
    return st.replace(destqueue=t(dq), dest=t(dq[np.arange(n), ptr]),
                      nq=t(nq, torch.int32),
                      destpointer=t(ptr, torch.int32),
                      znav=t(znav, torch.bool),
                      active=t(rng.uniform(size=n) >= INACTIVE, torch.bool))


def same(a, b) -> bool:
    """Bit for bit (a NaN equal to a NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        nan = torch.isnan(a) & torch.isnan(b)
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | nan).all())
    return torch.equal(a, b)


def assert_states_same(got, want, where=""):
    for f in TE._STATE_FIELDS:
        assert same(getattr(got, f), getattr(want, f)), (where, f)


def torch_chain_step(eng, st, cache):
    """One step of the engine's torch chain (`Engine.step_with_forces`
    without the kernels)."""
    fx, fy, new = eng.calc_forces(st, cache)
    return eng.finish_step(st, eng.dynamics(new, fx, fy)), fx, fy


@pytest.mark.cuda
def test_cuda_fused_twod_equals_torch_chain(cuda_device):
    """Over 300 eager steps of the routes crowd, the fused route (agent_pre's
    spline instance, K1, agent_post's twod instance) equals the torch
    chain bit for bit in every state field and the applied forces; the
    run holds step 0, last-destination rows, arrived (frozen) rows and
    inactive rows."""
    eng = twod_engine()
    st = routes_crowd(RIDERS, cuda_device)
    kernels = eng.agent_kernels(st)
    assert kernels is not None
    lookback = eng.dest_kw["lookback"]
    seen = dict.fromkeys(("step0", "last", "frozen", "inactive"), 0)
    for k in range(STEPS):
        if k % CFG["rebuild_every"] == 0:
            cache = eng.neighbor_cache(st)
        got, gfx, gfy = eng.fused_step(st, kernels, cache)
        want, wfx, wfy = torch_chain_step(eng, st, cache)
        assert same(gfx, wfx) and same(gfy, wfy), k
        assert_states_same(got, want, k)
        _, _, pre = TE.dest_force_spline(eng.params, st, lookback)
        act = st.active
        seen["step0"] += int(((st.i == 0) & act).sum())
        seen["last"] += int(((pre.destpointer >= st.nq - 1) & act).sum())
        seen["frozen"] += int((pre.znav[:, 2] & act).sum())
        seen["inactive"] += int((~act).sum())
        st = want
    torch.cuda.synchronize()
    assert all(seen.values()), seen
    assert torch.isfinite(st.s).all()


@pytest.mark.cuda
def test_cuda_graphed_twod_equals_eager(cuda_device):
    """A graphed 100-step run (five replays of a captured 20-step chunk)
    equals the eager steps bit for bit, and replays one agent_pre and one
    agent_post launch a step, no agent_post_whipple."""
    st = routes_crowd(RIDERS, cuda_device, seed=8)
    graphed, eager = twod_engine(), twod_engine()
    got, _ = graphed.simulate(st, GRAPH_STEPS, record=False)
    want, _ = eager.simulate(st, GRAPH_STEPS, record=False, graph=False)
    torch.cuda.synchronize()
    assert_states_same(got, want)
    runner, = graphed._runners.values()
    assert runner.graph is not None
    assert graphed.graph_launches(KERNELS) == (GRAPH_STEPS, GRAPH_STEPS, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 129, 8193])
def test_cuda_twod_kernels_match_plain(cuda_device, n):
    """At ragged sizes (a partial last warp, pad rows in the packs) and
    after 120 steps (the ring filled, riders on their last waypoint),
    each kernel equals its plain version bit for bit and is counted once
    per call."""
    eng = twod_engine()
    st = routes_crowd(n, cuda_device, seed=9)
    if n > 2:
        st, _ = eng.simulate(st, 120, record=False)
    npad = eng.pair_rows(n)
    before = tuple(fn.launches for fn in KERNELS)
    pre = AS.agent_pre(eng, st, npad)
    pre_r = AS.agent_pre_ref(eng, st, npad)
    for f in ("fdx", "fdy", "src_pack", "recv_pack"):
        assert same(getattr(pre, f), getattr(pre_r, f)), f
    assert_states_same(pre.state, pre_r.state)
    frx, fry = eng.pair_stage(st, pre_r.src_pack, pre_r.recv_pack)
    got = AS.agent_post(eng, st, pre_r, frx, fry)
    want = AS.agent_post_ref(eng, st, pre_r, frx, fry)
    torch.cuda.synchronize()
    assert same(got[1], want[1]) and same(got[2], want[2])
    assert_states_same(got[0], want[0])
    assert tuple(fn.launches - b for fn, b in zip(KERNELS, before)) == (
        1, 1, 0)


@pytest.mark.cuda
def test_cuda_short_ring_keeps_the_torch_chain(cuda_device):
    """A twod state whose ring (8 slots) is shorter than the lookback keeps
    the torch chain, which warns that it reads wrapped samples."""
    eng = twod_engine()
    st = routes_crowd(1024, cuda_device, hist=8)
    assert eng.agent_kernels(st) is None
    before = tuple(fn.launches for fn in KERNELS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.step(st)
    torch.cuda.synchronize()
    assert tuple(fn.launches for fn in KERNELS) == before
    assert any("ring buffer" in str(w.message) for w in caught)
