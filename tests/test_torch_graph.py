"""PyTorch port: the compiled chunk of `Engine.simulate` (`ChunkRunner`:
static buffers and, on the card, a CUDA graph of the `rebuild_every`
steps) held to the eager loop bit for bit, and the receiver blocks the
CUDA kernels do not take (block != 128: the plain version on CPU tensors,
an error on the card).

The graph itself runs only on a card. On the CPU the runner's static-
buffer logic (copy in, run, copy out, clone on return) runs through
`DirectRunner`, a `ChunkRunner` whose capture and replay call the chunk
directly. The JAX
package comes in through the `jx` fixture, so the card's tests also run
where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_graph.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import bicycle2d  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
K, STEPS = 5, 12          # two chunks and a 2-step tail
STATE_FIELDS = TE._STATE_FIELDS
# the JAX package's float32 bar for its Pallas kernels against its float64
# oracle (tests/test_neighbors.py): |port - JAX| <= ATOL + RTOL |JAX|
ATOL, RTOL = 1e-4, 2e-4


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from cyclistsocialforce_tpu import engine, make_state, params
    from cyclistsocialforce_tpu.models import bicycle2d as jax_bicycle2d

    return types.SimpleNamespace(jnp=jnp, JE=engine, JP=params,
                                 make_state=make_state,
                                 bicycle2d=jax_bicycle2d)


def make_engine(rep_force="twod", backend="pallas", rebuild_every=K,
                params=None, **kw):
    cfg = dict(cutoff=50.0, block=128, block_src=64, kb=24,
               rebuild_every=rebuild_every, backend=backend)
    if backend == "pallas_db":
        cfg["block_src"] = 128
    if rep_force == "legacy":
        cfg.update(cutoff=100.0, kb=70)
    return TE.Engine.create(params or BicycleParams.create(), bicycle2d,
                            rep_force=rep_force,
                            neighbors=TE.NeighborConfig(**{**cfg, **kw}))


def crowd(n, pad, device=DEV, seed=None):
    """The bench-style crowd; `seed` moves every rider by a seeded numpy
    draw, for a second, different state of the same shape."""
    st = build_population(n, 0.02, 8, pad, torch.float32, device)
    if seed is None:
        return st
    rng = np.random.default_rng(seed)
    shift = torch.as_tensor(rng.uniform(-3, 3, (st.n, 2)),
                            dtype=torch.float32, device=device)
    s = st.s.clone()
    s[:, :2] += shift
    return st.replace(s=s)


def snapshot(state, records):
    recs = records if isinstance(records, tuple) else (records,)
    return ({f: getattr(state, f).clone() for f in STATE_FIELDS},
            [None if r is None else r.clone() for r in recs])


def assert_same(state, records, snap):
    fields, recs = snap
    for f in STATE_FIELDS:
        assert torch.equal(getattr(state, f), fields[f]), f
    got = records if isinstance(records, tuple) else (records,)
    assert len(got) == len(recs)
    for g, w in zip(got, recs):
        assert (g is None and w is None) or torch.equal(g, w)


MODES = {
    "none": dict(record=False),
    "metrics_sorted": dict(record=False, record_metrics=True),
    "metrics_gather": dict(record_metrics=True),
    "states": dict(record=True),
    "forces": dict(record=True, record_forces=True),
}


class DirectRunner(TE.ChunkRunner):
    """`ChunkRunner` with the chunk called directly where the card
    captures and replays a graph. As there, the output state is made once
    (at the capture) and overwritten in place by every run."""

    def _capture(self):
        self.state_out = self._body()

    def _replay(self):
        TE._copy_state(self.state_out, self._body())


def simulate_direct(eng, state, steps, mode):
    """`Engine.simulate(state, steps, **MODES[mode])` with its chunks
    through a `DirectRunner`."""
    kw = {"record": True, **MODES[mode]}
    record_mode = ("metrics" if kw.get("record_metrics") else
                   None if not kw["record"] else
                   "forces" if kw.get("record_forces") else "states")
    return eng._simulate(state, steps, record_mode,
                         not kw["record"], DirectRunner)


# ---- the runner's static buffers, on the CPU ---------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("pad", [128, None])
def test_direct_runner_equals_eager_loop(mode, pad):
    """The runner's static buffers (the chunk run in place of a replay)
    equal the eager loop exactly in every state field and every
    record, on the sorted-resident path (512 rows) and the gather path
    (500 rows, padded packs)."""
    eng = make_engine()
    st = crowd(500 if pad is None else 512, pad)
    want = eng.simulate(st, STEPS, graph=False, **MODES[mode])
    assert not eng._runners
    got = simulate_direct(eng, st, STEPS, mode)
    assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert runner.replays == STEPS // K and runner.k == K
    assert runner.launches() == eng.graph_launches() == (0, 0, 0)
    assert runner.presorted == (pad == 128
                                and mode in ("none", "metrics_sorted"))


@pytest.mark.parametrize("mode", ["none", "metrics_sorted", "forces"])
def test_second_simulate_leaves_first_results_untouched(mode):
    """The runner's outputs are overwritten by its next run: `simulate`
    returns tensors of its own, none of them the runner's memory."""
    eng = make_engine()
    first = simulate_direct(eng, crowd(512, 128), STEPS - 2,
                            mode)                # ends on a chunk boundary
    snap = snapshot(*first)
    second = simulate_direct(eng, crowd(512, 128, seed=3), STEPS, mode)
    assert len(eng._runners) == 1                # one program, one runner
    assert_same(*first, snap)
    assert not torch.equal(second[0].s, first[0].s)
    runner, = eng._runners.values()
    static = {t.data_ptr() for s in (runner.state_in, runner.state_out)
              for t in (getattr(s, f) for f in STATE_FIELDS)}
    static |= {r.data_ptr() for r in runner.rows}
    static.discard(0)                # zero-width fields hold no memory
    for state, records in (first, second):
        recs = records if isinstance(records, tuple) else (records,)
        mine = [getattr(state, f) for f in STATE_FIELDS]
        mine += [r for r in recs if r is not None]
        assert not static & {t.data_ptr() for t in mine}


def test_runner_cache_is_keyed_by_the_program():
    eng = make_engine()
    st = crowd(512, 128)
    simulate_direct(eng, st, K, "none")
    simulate_direct(eng, st, 2 * K, "none")
    assert len(eng._runners) == 1
    simulate_direct(eng, st, K, "metrics_sorted")
    simulate_direct(eng, st, K, "states")                    # gather path
    simulate_direct(eng, crowd(256, 128), K, "none")
    assert len(eng._runners) == 4
    assert not eng.with_params(BicycleParams.create())._runners


def test_assigning_a_frozen_attribute_empties_the_caches():
    """A captured chunk and the kept pack columns froze what they read
    from the engine: assigning `params` (or `neighbors`, ...) drops both,
    and the next run equals a new engine's."""
    eng = make_engine()
    st = crowd(512, 128)
    simulate_direct(eng, st, K, "none")
    assert eng._runners and eng._columns
    weak = BicycleParams.create().replace(f_0=0.5 * BicycleParams.create().f_0)
    eng.params = weak
    assert not eng._runners and not eng._columns
    got = simulate_direct(eng, st, STEPS, "forces")
    want = make_engine(params=weak).simulate(st, STEPS, graph=False,
                                             **MODES["forces"])
    assert_same(*got, snapshot(*want))
    old = make_engine().simulate(st, STEPS, graph=False, **MODES["forces"])
    assert not torch.equal(old[1][1], want[1][1])
    # the kept columns are keyed by their values too
    src = eng.pack_pair_fields(st)[0]
    object.__setattr__(eng, "params", BicycleParams.create())
    assert not torch.equal(eng.pack_pair_fields(st)[0][:, 4], src[:, 4])


def test_engine_and_runner_form_no_reference_cycle():
    """Dropping an engine frees its runners (and on the card their CUDA
    graphs) at once, never later from the cyclic collector, which could
    run inside another graph's capture."""
    import gc
    import weakref

    eng = make_engine()
    simulate_direct(eng, crowd(256, 128), K, "none")
    runner = weakref.ref(next(iter(eng._runners.values())))
    gc.collect()
    gc.disable()
    try:
        del eng
        assert runner() is None
    finally:
        gc.enable()


def test_graph_argument_on_the_cpu():
    eng = make_engine()
    st = crowd(256, 128)
    with pytest.raises(ValueError, match="CUDA"):
        eng.simulate(st, STEPS, record=False, graph=True)
    with pytest.raises(ValueError, match="graph"):
        eng.simulate(st, STEPS, record=False, graph="yes")
    with pytest.raises(ValueError, match="graph"):
        eng.simulate(st, STEPS, record=False, graph="direct")
    # None on CPU tensors is the eager loop: no runner is built
    want = eng.simulate(st, STEPS, record_metrics=True, graph=False)
    got = eng.simulate(st, STEPS, record_metrics=True)
    assert_same(*got, snapshot(*want))
    assert not eng._runners
    assert PF.launch_counts() == (0, 0, 0)    # the plain version never counts


def test_capture_refuses_parameters_on_another_device():
    """Per-agent parameter tensors are not copied to the state's device
    inside a captured step: a capture checks first and says how to build
    them."""
    p = as_population(BicycleParams.create(), 8, device="cpu")
    TE._check_params_on(p, torch.device("cpu"))
    TE._check_params_on(BicycleParams.create(), torch.device("cuda", 0))
    with pytest.raises(ValueError, match="as_population"):
        TE._check_params_on(p, torch.device("cuda", 0))


def test_cache_carries_the_row_counts_and_the_kernels_take_them():
    eng = make_engine()
    st = crowd(512, 128)
    cache = eng.neighbor_cache(st)
    assert len(cache) == 5 and cache[4].dtype == torch.int32
    assert torch.equal(cache[4], cache[2].sum(dim=1).to(torch.int32))
    fx, fy = eng.repulsive_sum_neighbors(st, cache)
    gx, gy = eng.repulsive_sum_neighbors(st, cache[:4])
    assert torch.equal(fx, gx) and torch.equal(fy, gy)


def test_constant_pack_columns_are_built_once():
    """Shared parameters' columns are kept per (N, dtype, device); per-
    agent tables stay indexed by uid through a permutation."""
    eng = make_engine("legacy")
    st = crowd(256, 128)
    src0, recv0 = eng.pack_pair_fields(st)
    n_kept = len(eng._columns)
    assert n_kept > 0
    src1, _ = eng.pack_pair_fields(st)
    assert len(eng._columns) == n_kept and torch.equal(src0, src1)
    src0[:, 7] = -1.0                         # a pack is the caller's own
    assert torch.equal(eng.pack_pair_fields(st)[0], src1)
    eng.pack_pair_fields(crowd(128, 128))
    assert len(eng._columns) == 2 * n_kept
    # per-agent f_0: nothing kept for it, rows follow their uid
    rng = np.random.default_rng(5)
    p = as_population(BicycleParams.create(), st.n, device=DEV)
    p = p.replace(f_0=p.f_0 * torch.as_tensor(rng.uniform(0.5, 1.5, st.n)))
    per = make_engine(params=p)
    perm = torch.from_numpy(rng.permutation(st.n))
    src, _ = per.pack_pair_fields(st)
    src_p, _ = per.pack_pair_fields(TE.permute_state(st, perm))
    assert torch.equal(src_p, src[perm])
    assert not any(k[0] == "f_0" for k in per._columns)


# ---- receiver blocks other than 128 -----------------------------------------


def test_block_64_on_the_cpu_matches_jax_interpret(jx):
    """block 64 with block_src 32: the plain version in float32 against
    the JAX package's Pallas kernel in interpret mode."""
    n = 512
    st = crowd(n, 64)
    cfg = dict(cutoff=50.0, block=64, block_src=32, kb=40)
    teng = TE.Engine.create(BicycleParams.create(), bicycle2d,
                            rep_force="twod",
                            neighbors=TE.NeighborConfig(**cfg))
    jeng = jx.JE.Engine.create(
        jx.JP.BicycleParams.create(), jx.bicycle2d, rep_force="twod",
        neighbors=jx.JE.NeighborConfig(backend="interpret", **cfg))
    jst = jx.make_state(st.s[:, :5].numpy(), hist_len=8,
                        dtype=jx.jnp.float32)
    jst = jst.replace(active=jx.jnp.asarray(st.active.numpy()))
    assert not teng.neighbor_cache(st)[3].any()
    want = [np.asarray(f) for f in jeng.repulsive_sum_neighbors(jst)]
    got = teng.repulsive_sum_neighbors(st)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)
    assert np.abs(want[0]).max() > 1.0


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


KERNEL_OF = {"pallas": PF.pair_forces_neighbors,
             "pallas_unrolled": PF.pair_forces_neighbors_unrolled,
             "pallas_db": PF.pair_forces_neighbors_db}
CARD_STEPS, CARD_K = 45, 20        # two chunks and a 5-step tail


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "metrics_sorted"])
@pytest.mark.parametrize("rep_force", ["twod", "legacy"])
@pytest.mark.parametrize("backend", sorted(KERNEL_OF))
def test_cuda_graph_equals_eager(cuda_device, backend, rep_force, mode):
    """The graphed run equals the eager loop bit for bit. The wrappers
    count what they launch (the warm-up chunk of the capturing call and
    the leftover steps), the capture records k launches of the backend's
    kernel, and the engine counts replays x k."""
    eng = make_engine(rep_force, backend, CARD_K)
    st = crowd(4096, 128, cuda_device)
    assert not eng.neighbor_cache(st)[3].any()
    want = eng.simulate(st, CARD_STEPS, graph=False, **MODES[mode])

    def only(n):
        return tuple(n * (fn is KERNEL_OF[backend]) for fn in PF.KERNELS)

    tail = CARD_STEPS % CARD_K
    for call, warm_up in ((1, CARD_K), (2, 0)):  # the capture, then replays
        PF.reset_launches()
        got = eng.simulate(st, CARD_STEPS, graph=True, **MODES[mode])
        torch.cuda.synchronize()
        assert PF.launch_counts() == only(warm_up + tail)
        assert eng.graph_launches() == only(call * (CARD_STEPS - tail))
        assert_same(*got, snapshot(*want))
    runner, = eng._runners.values()
    assert runner.graph is not None and runner.presorted
    assert runner.captured == only(CARD_K)
    assert runner.replays == 2 * (CARD_STEPS // CARD_K)
    assert torch.isfinite(got[0].s).all()


@pytest.mark.cuda
def test_cuda_graph_true_needs_chunks(cuda_device):
    """graph=True where there is nothing to capture: fewer steps than a
    chunk, per-step rebuilds, the dense stage."""
    st = crowd(256, 128, cuda_device)
    for e, steps in ((make_engine(), K - 1),
                     (make_engine(rebuild_every=1), 4)):
        with pytest.raises(ValueError, match="rebuild_every"):
            e.simulate(st, steps, record=False, graph=True)
    dense = TE.Engine.create(BicycleParams.create(), bicycle2d,
                             rep_force="twod")
    with pytest.raises(ValueError, match="rebuild_every"):
        dense.simulate(crowd(64, None, cuda_device), 3, graph=True)


@pytest.mark.cuda
def test_cuda_assigning_params_captures_anew(cuda_device):
    """Assigning `engine.params` drops the captured graphs: the next
    graphed run is the new parameters' eager run, bit for bit."""
    eng = make_engine(rebuild_every=CARD_K)
    st = crowd(4096, 128, cuda_device)
    old, _ = eng.simulate(st, CARD_STEPS, record=False)
    weak = BicycleParams.create().replace(f_0=0.5 * BicycleParams.create().f_0)
    eng.params = weak
    assert not eng._runners
    got = eng.simulate(st, CARD_STEPS, record=False)
    want = make_engine(params=weak, rebuild_every=CARD_K).simulate(
        st, CARD_STEPS, record=False, graph=False)
    assert_same(*got, snapshot(*want))
    assert not torch.equal(got[0].s, old.s)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["metrics_gather", "states", "forces"])
def test_cuda_graph_equals_eager_on_the_gather_path(cuda_device, mode):
    eng = make_engine(rebuild_every=CARD_K)
    for n, pad in ((4096, 128), (4000, None)):
        st = crowd(n, pad, cuda_device)
        want = eng.simulate(st, CARD_STEPS, graph=False, **MODES[mode])
        got = eng.simulate(st, CARD_STEPS, **MODES[mode])   # the default
        assert_same(*got, snapshot(*want))
    assert len(eng._runners) == 2
    assert all(r.graph is not None and not r.presorted
               for r in eng._runners.values())


@pytest.mark.cuda
def test_cuda_second_simulate_leaves_first_results_untouched(cuda_device):
    eng = make_engine(rebuild_every=CARD_K)
    for mode in ("none", "forces"):
        first = eng.simulate(crowd(4096, 128, cuda_device), 2 * CARD_K,
                             **MODES[mode])
        snap = snapshot(*first)
        second = eng.simulate(crowd(4096, 128, cuda_device, seed=3),
                              CARD_STEPS, **MODES[mode])
        torch.cuda.synchronize()
        assert_same(*first, snap)
        assert not torch.equal(second[0].s, first[0].s)


@pytest.mark.cuda
def test_cuda_chunk_body_has_no_sync_point(cuda_device):
    """One eager chunk on the card with every host synchronisation an
    error: what a capture would refuse."""
    for rep_force in ("twod", "legacy"):
        eng = make_engine(rep_force, rebuild_every=CARD_K)
        st = crowd(4096, 128, cuda_device)
        cache = eng.neighbor_cache(st)
        st = TE.permute_state(st, cache[0])
        rows = TE.record_buffers("metrics", CARD_K, st)
        eng.run_chunk(st, cache, 1, True)            # builds, kept columns
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.run_chunk(st, cache, CARD_K, True, "metrics", rows,
                          cache[3].sum())
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(rows[0]).all()


@pytest.mark.cuda
def test_cuda_graph_refuses_parameters_on_the_cpu(cuda_device):
    st = crowd(512, 128, cuda_device)
    p = as_population(BicycleParams.create(), st.n, device="cpu")
    eng = make_engine(params=p, rebuild_every=CARD_K)
    with pytest.raises(ValueError, match="as_population"):
        eng.simulate(st, CARD_K, record=False)
    assert not eng._runners


@pytest.mark.cuda
@pytest.mark.parametrize("backend", sorted(KERNEL_OF))
def test_cuda_block_64_raises(cuda_device, backend):
    """A receiver block the kernels do not take: on CUDA tensors an error
    that names 128, never the plain version, and no launch counted."""
    block_src = 64 if backend == "pallas_db" else 32
    cfg = dict(cutoff=50.0, block=64, block_src=block_src, kb=40,
               backend=backend)
    eng = TE.Engine.create(BicycleParams.create(), bicycle2d,
                           rep_force="twod",
                           neighbors=TE.NeighborConfig(**cfg))
    st = crowd(2048, 64, cuda_device)
    PF.reset_launches()
    with pytest.raises(ValueError, match="128.*block = 64"):
        eng.repulsive_sum_neighbors(st)
    with pytest.raises(ValueError, match="128.*block = 64"):
        eng.simulate(st, 3, record=False)
    assert PF.launch_counts() == (0, 0, 0)
    fx, _ = eng.repulsive_sum_neighbors(st.to("cpu"))  # the CPU takes it
    assert fx.abs().max() > 1.0
