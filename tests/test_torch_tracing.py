"""PyTorch port: the spans and counters of the step loop (`tracing`) and
the benchmark's readers of them.

On the CPU the spans have host times only; the test marked `cuda` holds
their stream times to a chunk's wall on the card:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tracing.py
"""

import json
import time

import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch import tracing  # noqa: E402
from cyclistsocialforce_tpu_torch.models import bicycle2d  # noqa: E402
from cyclistsocialforce_tpu_torch.parallel import sharding  # noqa: E402
from cyclistsocialforce_tpu_torch.params import BicycleParams  # noqa: E402
from cyclistsocialforce_tpu_torch.scenario import Scenario  # noqa: E402
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402

torch.set_num_threads(1)

K = 5                 # steps per table rebuild
STAGING = ("permute", "load", "copy_out", "unpermute")
READERS = ("rebuild_ms_per_step", "staging_ms_per_step",
           "host_issue_ms_per_step", "table_pair_yield_pct")


def make_engine(kb=24, block=128, block_src=64):
    return TE.Engine.create(BicycleParams.create(), bicycle2d,
                            rep_force="twod",
                            neighbors=TE.NeighborConfig(
                                cutoff=50.0, block=block,
                                block_src=block_src, kb=kb,
                                rebuild_every=K))


def crowd(n=512, device="cpu"):
    return build_population(n, 0.02, 8, 128, torch.float32, device)


class DirectRunner(TE.ChunkRunner):
    """`ChunkRunner` with the chunk called directly where the card
    captures and replays a graph (as in test_torch_graph.py)."""

    def _capture(self):
        self.state_out = self._body()

    def _replay(self):
        TE._copy_state(self.state_out, self._body())


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def inside(event, outer):
    return (outer.time_range.start <= event.time_range.start
            and event.time_range.end <= outer.time_range.end)


def test_profiled_simulate_records_rebuilds_and_nests_its_spans():
    """Under a CPU profiler, two chunks of `rebuild_every` steps record
    two rebuilds and their steps, and each phase's span sits inside
    `csf::simulate` in the profiler's own trace."""
    from torch.profiler import ProfilerActivity, profile

    eng, st = make_engine(), crowd()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.simulate(st, 2 * K, record=False)
    rep = tracing.report()
    assert rep["steps"] == 2 * K
    assert rep["counters"]["steps"] == 2 * K
    assert rep["counters"]["rebuilds"] == 2
    assert rep["spans"]["csf::rebuild"]["count"] == 2
    assert rep["spans"]["csf::permute"]["count"] == 2
    assert rep["spans"]["csf::unpermute"]["count"] == 1
    assert rep["spans"]["csf::replay"]["count"] == 2
    assert all(s["stream_ms"] is None for s in rep["spans"].values())
    events = [e for e in prof.events() if e.name.startswith("csf::")]
    # host operations, not user annotations: the profiler draws no range
    # on the device's timeline for them
    assert not any(getattr(e, "is_user_annotation", False) for e in events)
    sim = [e for e in events if e.name == "csf::simulate"]
    assert len(sim) == 1
    for name in ("csf::rebuild", "csf::permute", "csf::unpermute",
                 "csf::replay"):
        found = [e for e in events if e.name == name]
        assert found and all(inside(e, sim[0]) for e in found), name
    parents = {sp.name: sp.parent for sp in tracing.RECORDER.spans}
    assert parents["csf::simulate"] is None
    assert parents["csf::rebuild"].name == "csf::simulate"


@pytest.mark.parametrize("tail", [0, 1])
def test_table_pairs_are_the_valid_slots_of_each_table(tail):
    """`table_pairs` is each table's valid slots x block x block_src x
    the steps it serves, worked by hand from `Engine.neighbor_cache`; a
    leftover step builds a table of its own."""
    eng, st = make_engine(), crowd()
    cfg = eng.neighbors
    want = int(eng.neighbor_cache(st)[4].sum()) * cfg.block \
        * cfg.block_src * K
    if tail:
        after, _ = eng.simulate(st, K, record=False)
        want += int(eng.neighbor_cache(after)[4].sum()) * cfg.block \
            * cfg.block_src
    with tracing.recording():
        eng.simulate(st, K + tail, record=False)
    counters = tracing.report()["counters"]
    assert counters["table_pairs"] == want
    assert counters["rebuilds"] == 1 + tail
    assert counters["table_overflow_rows"] == 0


def test_table_overflow_rows_counts_the_overflowed_blocks():
    """A table of two source blocks overflows on a crowd of 1,024:
    `table_overflow_rows` is the overflow flags' sum."""
    eng, st = make_engine(kb=2), crowd(1024)
    want = int(eng.neighbor_cache(st)[3].sum())
    assert want > 0
    with tracing.recording():
        eng.simulate(st, K, record=False)
    assert tracing.report()["counters"]["table_overflow_rows"] == want


def test_growth_counts_only_the_recorded_blocks():
    """`growth` adds how far a count grows inside a recorded block, none
    of what it grows outside one, and nothing for a count of None (the
    plain version's engine on the CPU: `Engine.field_pairs`)."""
    count = torch.zeros(1, dtype=torch.int64)
    with tracing.recording():
        with tracing.growth(tracing.probe("cpu"), "grown", count):
            count += 5
    count += 100
    with tracing.growth(tracing.probe("cpu"), "grown", count):
        count += 7
    with tracing.recording():
        with tracing.growth(tracing.probe("cpu"), "grown", count):
            count += 2
        with tracing.growth(tracing.probe("cpu"), "grown", None):
            count += 1
    assert tracing.report()["counters"]["grown"] == 7
    eng = make_engine()
    assert eng.field_pairs("cpu") is None
    with tracing.recording():
        eng.simulate(crowd(), K, record=False)
    assert "field_pairs" not in tracing.report()["counters"]


def test_off_records_nothing_and_changes_nothing(monkeypatch):
    """With no profiler and no `recording()`, `simulate` enters no
    record function, makes no span or CUDA event and adds to no
    counter, and gives the state that a recorded run gives, bit for
    bit."""
    eng, st = make_engine(), crowd()
    with tracing.recording():
        on, _ = eng.simulate(st, 2 * K + 1, record=False)
    before = json.dumps(tracing.report()["counters"])

    def refuse(*args, **kwargs):
        raise AssertionError("recorded while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_host_operation", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing.Span, "__init__", refuse)
    monkeypatch.setattr(tracing.Recorder, "count", refuse)
    off, _ = eng.simulate(st, 2 * K + 1, record=False)
    for f in TE._STATE_FIELDS:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert json.dumps(tracing.report()["counters"]) == before


def test_second_simulate_adds_no_captures():
    """The first run of a program captures its chunk (`captures`, a
    `csf::capture` span); a second run replays it, through `csf::load`
    and `csf::replay`, and captures nothing."""
    eng, st = make_engine(), crowd()
    with tracing.recording():
        probe = tracing.probe(st.device)
        eng._simulate(st, 2 * K, None, True, DirectRunner, probe)
        first = tracing.report()
        eng._simulate(st, 2 * K, None, True, DirectRunner, probe)
    second = tracing.report()
    assert first["counters"]["captures"] == 1
    assert second["counters"]["captures"] == 1
    assert second["spans"]["csf::capture"]["count"] == 1
    assert second["spans"]["csf::load"]["count"] == 4
    assert second["spans"]["csf::replay"]["count"] == 4
    assert second["spans"]["csf::copy_out"]["count"] == 2


def test_step_chunk_holds_simulate():
    """`Scenario.step_chunk` opens `csf::chunk`, the parent of the
    `csf::simulate` it calls."""
    scen = Scenario(make_engine(), crowd(), chunk=K)
    with tracing.recording():
        scen.step_chunk(record=False)
    spans = {sp.name: sp for sp in tracing.RECORDER.spans}
    assert spans["csf::simulate"].parent is spans["csf::chunk"]
    assert tracing.report()["steps"] == K


def test_mesh_times_its_collectives_as_spans():
    """`Mesh.timing` takes each collective's span and `collective_seconds`
    sums them; under `recording()` the recorder takes them too."""
    mesh = sharding.Mesh(2, range(2), "cpu")
    parts = [torch.ones(4), torch.zeros(4)]
    mesh.timing = []
    with tracing.recording():
        mesh.all_gather(parts)
        mesh.pmax([torch.tensor(1.0), torch.tensor(2.0)])
    assert [sp.name for sp in mesh.timing] == ["csf::collective"] * 2
    assert mesh.collective_seconds() == pytest.approx(
        sum(1e-3 * sp.host_ms() for sp in mesh.timing))
    assert mesh.collective_seconds() > 0
    assert tracing.report()["spans"]["csf::collective"]["count"] == 2
    mesh.timing = None
    mesh.all_gather(parts)
    assert mesh.collective_seconds() == 0.0
    assert tracing.report()["spans"]["csf::collective"]["count"] == 2


def test_folding_keeps_the_report(monkeypatch):
    """A long recording folds its finished spans and its counters' device
    tensors; the report reads the same."""
    eng, st = make_engine(), crowd()
    with tracing.recording():
        eng.simulate(st, 3 * K, record=False)
    want = tracing.report()
    tracing.clear()
    monkeypatch.setattr(tracing, "FOLD_COUNTS", 2)
    monkeypatch.setattr(tracing, "FOLD_SPANS", 3)
    with tracing.recording():
        eng.simulate(st, 3 * K, record=False)
    got = tracing.report()
    assert len(tracing.RECORDER.spans) < 3
    assert got["counters"] == want["counters"]
    assert {k: v["count"] for k, v in got["spans"].items()} == \
        {k: v["count"] for k, v in want["spans"].items()}


# ---- the benchmark's readers -------------------------------------------


def read(name, ctx):
    from benchmark import harness

    return harness.load_reader(name).read(ctx)


def test_readers_of_the_recorder():
    """The four readers on a CPU run's report and a hand-made ctx."""
    eng, st = make_engine(), crowd()
    with tracing.recording():
        eng.simulate(st, 2 * K, record=False)
    rep = tracing.report()
    ctx = {"steps": 2 * K, "pairs": 1.0e6, "program_report": rep}
    assert read("table_pair_yield_pct", ctx) == pytest.approx(
        100.0 * 1.0e6 / rep["counters"]["table_pairs"])
    assert read("host_issue_ms_per_step", ctx) == pytest.approx(
        rep["spans"]["csf::simulate"]["host_ms"] / (2 * K))
    # no stream time on the CPU
    assert read("rebuild_ms_per_step", ctx) is None
    assert read("staging_ms_per_step", ctx) is None
    for bad in ({**ctx, "steps": K}, {**ctx, "program_report": {
            **rep, "steps": 0}}):
        for name in READERS:
            assert read(name, bad) is None, name


def test_readers_of_stream_times():
    """Stream times per step over a report made by hand, as on a card:
    the staging sum leaves out the spans that did not run."""
    spans = {"csf::rebuild": {"count": 5, "host_ms": 9.0, "stream_ms": 2.0},
             "csf::permute": {"count": 5, "host_ms": 1.0, "stream_ms": 0.5},
             "csf::load": {"count": 5, "host_ms": 1.0, "stream_ms": 1.0},
             "csf::unpermute": {"count": 1, "host_ms": 0.1,
                                "stream_ms": 0.5},
             "csf::simulate": {"count": 1, "host_ms": 20.0,
                               "stream_ms": 40.0}}
    ctx = {"steps": 100, "pairs": 5.0, "program_report": {
        "steps": 100, "spans": spans, "counters": {"table_pairs": 50}}}
    assert read("rebuild_ms_per_step", ctx) == pytest.approx(0.02)
    assert read("staging_ms_per_step", ctx) == pytest.approx(0.02)
    assert read("host_issue_ms_per_step", ctx) == pytest.approx(0.2)
    assert read("table_pair_yield_pct", ctx) == pytest.approx(10.0)


def test_reader_entries_name_cells_and_files():
    from benchmark import harness

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cells = {w["name"] for w in spec["workloads"]}
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert set(m["workloads"]) <= cells and m["workloads"]
        assert (harness.BENCH / "layer_metrics" / f"{name}.py").is_file()
        reader = harness.load_reader(name)
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
            m["unit"], m["layer"], m["moves"])


# ---- on the card -------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (stream times and graphs)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_replays_have_stream_times_within_the_chunk(cuda_device):
    """Graph replays record `csf::replay` and `csf::load` with stream
    times above 0, which together stay under the chunk's wall."""
    scen = Scenario(make_engine(), crowd(4096, cuda_device), chunk=4 * K)
    scen.step_chunk(record=False)           # the capture
    torch.cuda.synchronize()
    tracing.clear()
    t0 = time.perf_counter()
    with tracing.recording():
        scen.step_chunk(record=False)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rep = tracing.report()
    assert rep["counters"].get("captures", 0) == 0
    assert rep["spans"]["csf::replay"]["count"] == 4
    stream = [rep["spans"][f"csf::{n}"]["stream_ms"] for n in ("replay",
                                                             "load")]
    assert all(ms > 0 for ms in stream)
    assert sum(stream) < wall_ms
    # the entry points' spans have host times only
    for name in ("csf::chunk", "csf::sync", "csf::simulate"):
        assert rep["spans"][name]["stream_ms"] is None
        assert rep["spans"][name]["host_ms"] > 0


@pytest.mark.cuda
def test_cuda_field_pairs_cover_the_recorded_steps(cuda_device):
    """K1 adds its evaluated pairs to the engine's counter in every graphed
    and eager step; a recording reports what the counter grew by in its
    own `simulate` calls, no more than the tables' walked pairs, and the
    unrecorded call between them adds nothing to the report."""
    eng, st = make_engine(), crowd(4096, cuda_device)
    scen = Scenario(eng, st, chunk=4 * K)
    scen.step_chunk(record=False)           # the capture
    counter = eng.field_pairs(cuda_device)
    torch.cuda.synchronize()
    tracing.clear()
    before = int(counter)
    with tracing.recording():
        scen.step_chunk(record=False)
    torch.cuda.synchronize()
    first = int(counter) - before
    scen.step_chunk(record=False)
    with tracing.recording():
        eng.simulate(scen.state, 3, record=False, graph=False)
    torch.cuda.synchronize()
    counters = tracing.report()["counters"]
    assert counters["steps"] == 4 * K + 3
    assert 0 < first < counters["field_pairs"]
    assert counters["field_pairs"] < 0.6 * counters["table_pairs"]
    assert counters["field_pairs"] % 32 == 0


@pytest.mark.cuda
def test_cuda_mesh_collectives_have_stream_times(cuda_device):
    """On a card `collective_seconds` sums the collectives' stream
    times."""
    mesh = sharding.Mesh(2, range(2), cuda_device)
    mesh.timing = []
    parts = [torch.ones(1 << 20, device=cuda_device),
             torch.zeros(1 << 20, device=cuda_device)]
    mesh.all_gather(parts)
    torch.cuda.synchronize()
    stream = [sp.stream_ms() for sp in mesh.timing]
    assert len(stream) == 1 and stream[0] > 0
    assert mesh.collective_seconds() == pytest.approx(1e-3 * stream[0])
