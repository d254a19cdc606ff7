"""PyTorch port: the balancing rider's post kernel (`agent_post_whipple`,
`csrc/agent_step.cu`) on the fused route. On the CPU: which engines the
rule admits (the model's `agent_kernels` hook and `Engine.agent_kernels`:
the benchmark's balancing-rider configuration) and which gain modes keep
the torch chain, and the fused
route's plain versions against the engine's torch chain bit for bit over
20 steps, with the route's functional contract. On the card (`cuda`
marker): the kernel against its plain version bit for bit at 2, 129 and
8,193 rows and, through a captured 20-step chunk, at 100,096 rows against
the torch chain, and its launch counter.

No test here imports the JAX package: the torch chain is the reference
(tests/test_torch_balancingrider.py holds it to JAX)."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch import params as P  # noqa: E402
from cyclistsocialforce_tpu_torch.models import (MODELS,  # noqa: E402
                                                 balancingrider, prepare)
from cyclistsocialforce_tpu_torch.ops import agent_step as AS  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BalancingRiderParams, BicycleParams)
from cyclistsocialforce_tpu_torch.scenarios import (  # noqa: E402
    build_flagship_crowd, build_population)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
ROOT = Path(__file__).resolve().parents[1]
BENCH_CONFIG = ROOT / "benchmark" / "configs" / "balancingrider_poly.json"
CFG = dict(cutoff=50.0, block=128, block_src=64, kb=24, rebuild_every=5,
           screen=False)
# speeds of the test crowd: below the gains fit's band (2 m/s), inside
# it, and at its top edge, the speed limit (10 m/s); the riders ask for
# V_DESIRED, so a rider at the limit keeps its speed and its cached gains
SPEEDS = (0.5, 1.5, 3.0, 5.0, 9.999, 10.0)
V_DESIRED = 12.0
STEPS, REBUILD = 20, 5
FIXED_GAINS = [-13.14, 1.10, -6.69, -0.11, -11.38]
HIST = 8        # the ring the rule is asked for (the rider reads no lookback)


def bench_engine():
    """The engine of the benchmark's balancing-rider configuration, built
    as `benchmark/harness.py` builds it."""
    cfg = json.loads(BENCH_CONFIG.read_text())
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["params"].items()}
    params = getattr(P, cfg["params_class"]).create(**cfg["create"], **kw)
    return TE.Engine.create(params, MODELS[cfg["model"]],
                            rep_force=cfg["rep_force"],
                            dest_force=cfg["dest_force"],
                            neighbors=TE.NeighborConfig(**cfg["neighbors"]))


@functools.lru_cache(maxsize=None)
def poly_params():
    """gains_poly=16 with the riders asking for V_DESIRED."""
    return BalancingRiderParams.create(gains_poly=16,
                                       v_desired_default=V_DESIRED)


def br_engine(params=None, **kw):
    return TE.Engine.create(params or poly_params(), MODELS["balancingrider"],
                            neighbors=TE.NeighborConfig(**{**CFG, **kw}))


def crowd(n, params=None, device=DEV, seed=3):
    """A stable crowd (headings toward destinations 100 m ahead) at
    0.02 /m^2 with speeds drawn from SPEEDS, 10% of the rows inactive,
    after `prepare`."""
    st = build_flagship_crowd(n, 0.02, 8, None, torch.float32, device)
    rng = np.random.default_rng(seed)
    s = st.s.clone()
    s[:, 3] = torch.as_tensor(rng.choice(SPEEDS, n), dtype=torch.float32,
                              device=device)
    active = torch.as_tensor(rng.uniform(size=n) >= 0.1, device=device)
    return prepare(MODELS["balancingrider"], params or poly_params(),
                   st.replace(s=s, active=active))


def test_rule_admits_the_benchmark_configuration():
    """The benchmark's balancing rider (gains_poly=16, the twod field
    culled through K1) takes agent_pre and agent_post_whipple."""
    eng = bench_engine()
    assert balancingrider.gain_mode(eng.params) == "poly"
    declared = balancingrider.agent_kernels(eng.params)
    assert (declared.dest, declared.post) == ("straight",
                                              "agent_post_whipple")
    assert eng.kernels_on(torch.device("cpu"), HIST) == declared
    # on the CPU every state keeps the torch chain
    assert eng.agent_kernels(crowd(64)) is None


def refused(mode):
    """(params, the mode `balancingrider.gain_mode` reports) of each
    refused case: `step` takes the gains' fit before it resamples, and
    the disturbances come on top of any mode."""
    base = poly_params()
    if mode == "stochastic":
        return base.replace(stochastic_control_behavior=True), "poly"
    if mode == "br_disturb":
        return base.replace(p_dist_roll=0.01), "poly"
    if mode == "per-rider t_s":
        return base.replace(t_s=torch.full((64,), 0.01,
                                           dtype=torch.float64)), "poly"
    kw = {"gains_lut": {"gains_lut": 64}, "prop_poly": {"prop_poly": 16},
          "prop_lut": {"prop_lut": 64}, "exact": {},
          "fixed": {"gains": FIXED_GAINS, "gains_poly": 16}}[mode]
    want = {"gains_lut": "lut"}.get(mode, mode)
    return BalancingRiderParams.create(**kw), want


@pytest.mark.parametrize("mode", ["stochastic", "br_disturb", "gains_lut",
                                  "prop_poly", "prop_lut", "exact", "fixed",
                                  "per-rider t_s"])
def test_rule_refuses(mode):
    """Every other gain mode, and a per-rider time step, keeps the torch
    chain; the rule says which mode it saw."""
    params, want = refused(mode)
    eng = br_engine(params)
    assert balancingrider.gain_mode(params) == want
    assert eng.kernels_on(torch.device("cpu"), HIST) is None
    if mode != "per-rider t_s":
        assert balancingrider.agent_kernels(params) is None


def test_rule_refuses_the_legacy_field_and_a_dense_stage():
    """The balancing rider takes the post kernel with the twod field culled
    only."""
    legacy = TE.Engine.create(poly_params(), MODELS["balancingrider"],
                              rep_force="legacy",
                              neighbors=TE.NeighborConfig(**CFG))
    dense = TE.Engine.create(poly_params(), MODELS["balancingrider"])
    for eng in (legacy, dense):
        assert eng.kernels_on(torch.device("cpu"), HIST) is None


def test_plain_route_equals_torch_chain_over_20_steps():
    """The fused route on the CPU (agent_pre's and agent_post_whipple's
    plain versions around the pair stage) is the engine's torch chain bit
    for bit in every field over 20 steps with a table rebuild every 5, on
    a crowd with inactive rows, riders below the fit's band, at its top
    edge, and rows whose speed does not change (their gains held)."""
    eng = br_engine()
    st = crowd(500)
    v0 = st.s[st.active, 3]
    assert (v0 < 2.0).any() and (v0 == 10.0).any()
    held = 0
    for k in range(STEPS):
        if k % REBUILD == 0:
            cache = eng.neighbor_cache(st)
        want, wfx, wfy = eng.step_with_forces(st, cache)
        got, gfx, gfy = eng.fused_step(st, eng.kernels_on(DEV, st.hist_len),
                                       cache)
        assert torch.equal(gfx, wfx) and torch.equal(gfy, wfy), k
        for f in TE._STATE_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (k, f)
        same = st.active & (want.s[:, 3] == st.s[:, 3])
        assert torch.equal(want.dyn_gains[same], st.dyn_gains[same])
        held += int(same.sum())
        st = want
    assert held > 0
    assert torch.isfinite(st.s).all() and (~st.active).any()


def test_whipple_contract_and_cpu_wrapper():
    """On CPU tensors the wrapper is its plain version bit for bit and
    counts no launch; the step leaves its argument untouched, the fields
    it does not change are the argument's own tensors and the others
    fresh ones."""
    AS.agent_post_whipple.launches = 0
    eng = br_engine()
    st = crowd(300)
    keep = {f: getattr(st, f).clone() for f in TE._STATE_FIELDS}
    pre = AS.agent_pre_ref(eng, st, eng.pair_rows(st.n))
    frx, fry = eng.pair_stage(st, pre.src_pack, pre.recv_pack)
    got = AS.agent_post_whipple(eng, st, pre, frx, fry)
    want = AS.agent_post_whipple_ref(eng, st, pre, frx, fry)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert AS.agent_post_whipple.launches == 0
    new, _, _ = eng.fused_step(st, eng.kernels_on(DEV, st.hist_len))
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(st, f), keep[f]), f
        shared = getattr(new, f) is getattr(st, f)
        assert shared == (f in AS.UNCHANGED_WHIPPLE), f
    assert not torch.equal(new.dyn_x, st.dyn_x)
    assert int(new.t_glob) == int(st.t_glob) + 1


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the per-agent kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def assert_states_equal(got, want):
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 129, 8193])
def test_cuda_whipple_kernel_matches_plain(cuda_device, n):
    """On the card agent_post_whipple equals its plain version bit for bit
    in the forces and every state field (and agent_pre its own on the
    balancing-rider engine), counted once per call."""
    eng = br_engine()
    st = crowd(n, device=cuda_device)
    assert eng.agent_kernels(st) is not None
    npad = eng.pair_rows(n)
    pre = AS.agent_pre(eng, st, npad)
    pre_r = AS.agent_pre_ref(eng, st, npad)
    for f in ("fdx", "fdy", "src_pack", "recv_pack"):
        assert torch.equal(getattr(pre, f), getattr(pre_r, f)), f
    assert_states_equal(pre.state, pre_r.state)
    frx, fry = eng.pair_stage(st, pre_r.src_pack, pre_r.recv_pack)
    before = AS.agent_post_whipple.launches, AS.agent_post.launches
    got = AS.agent_post_whipple(eng, st, pre_r, frx, fry)
    want = AS.agent_post_whipple_ref(eng, st, pre_r, frx, fry)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert_states_equal(got[0], want[0])
    assert torch.isfinite(got[0].s).all()
    assert (AS.agent_post_whipple.launches, AS.agent_post.launches) == (
        before[0] + 1, before[1])
    with pytest.raises(ValueError, match="fused form"):
        AS.agent_post(eng, st, pre_r, frx, fry)


@pytest.mark.cuda
def test_cuda_captured_chunk_equals_torch_chain(cuda_device, monkeypatch):
    """100,096 rows of the benchmark's crowd and configuration through one
    captured 20-step chunk on the fused route equal the torch chain's run
    bit for bit; the chunk replays one agent_pre and one
    agent_post_whipple launch a step and no agent_post."""
    st = prepare(MODELS["balancingrider"], bench_engine().params,
                 build_population(100_000, 0.02, 8, 128, torch.float32,
                                  cuda_device, model="balancingrider"))
    assert st.n == 100_096
    plain, fused = bench_engine(), bench_engine()
    with monkeypatch.context() as m:
        m.setattr(plain, "agent_kernels", lambda state: None)
        want, _ = plain.simulate(st, STEPS, record=False, graph=False)
    kernels = (AS.agent_pre, AS.agent_post, AS.agent_post_whipple)
    got, _ = fused.simulate(st, STEPS, record=False)
    torch.cuda.synchronize()
    assert_states_equal(got, want)
    assert torch.isfinite(got.s).all()
    runner, = fused._runners.values()
    assert runner.graph is not None and runner.replays == 1
    assert fused.graph_launches(kernels) == (STEPS, 0, STEPS)
    assert plain.graph_launches(kernels) == (0, 0, 0)


@pytest.mark.cuda
def test_cuda_launch_counter_by_model(cuda_device):
    """An eager step launches agent_post_whipple once on a balancing-rider
    engine and never on a bicycle2d one, which launches agent_post."""
    kernels = (AS.agent_pre, AS.agent_post, AS.agent_post_whipple)
    counts = {}
    bike = TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                            rep_force="twod",
                            neighbors=TE.NeighborConfig(**CFG))
    bike_state = build_population(1024, 0.02, 8, 128, torch.float32,
                                  cuda_device)
    for name, eng, st in (("balancingrider", br_engine(),
                           crowd(1024, device=cuda_device)),
                          ("bicycle2d", bike, bike_state)):
        before = tuple(fn.launches for fn in kernels)
        eng.step(st)
        torch.cuda.synchronize()
        counts[name] = tuple(fn.launches - b
                             for fn, b in zip(kernels, before))
    assert counts == {"balancingrider": (1, 0, 1), "bicycle2d": (1, 1, 0)}
