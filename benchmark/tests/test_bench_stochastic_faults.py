"""The stochastic balancing rider's configuration driven through the
whole harness on the CPU at a small size (no look for a card): a sound
run is `correct`; each fault a cell can have (`test_bench_faults.FAULTS`),
and the draws' own faults, make it not: the program drawing its poles
under the wrong salt, and the reference drawing in float64 where the
configuration draws in float32. The control, the reference in bfloat16,
fails the limits where the program's float32 run passes them.

The configuration has no cell in BENCHMARK.json (the program's float32
riders go non-finite on a few seeds in a hundred at 100,000 riders,
PERF.md): `small_cell` hands the harness a cell of this test's own, on
`dense_100k`'s mix cut to SMALL and held to the deterministic balancing
rider's limits. The chunks are the mix's 100 steps, one to an episode:
at this size the draws' faults, a step that returns its state, and half
the batch left out show within 100 steps, not within 20."""

import pytest
import torch

import cyclistsocialforce_tpu_torch.models.balancingrider as program_rider
from benchmark import control, harness
from benchmark.reference import random as rnd
from cyclistsocialforce_tpu_torch.engine import Engine
from test_bench_faults import FAULTS, few_rows_altered, pairs_left_out

CELL = {"name": "balancingrider-stochastic-small",
        "config": "balancingrider_stochastic", "traffic": "dense_100k",
        "chips": 1}
LIMITS = "balancingrider-dense-100k"
SMALL = {"n_riders": 600, "episode_steps": 100, "chunk_steps": 100}
uniform = rnd.uniform


@pytest.fixture
def small_cell(monkeypatch):
    """`harness.cell_files` that finds this test's cell by its name: the
    stochastic configuration, its mix cut to SMALL, the limits of
    LIMITS."""
    found = harness.cell_files

    def load(*parts):
        return harness.load_json(harness.BENCH.joinpath(*parts))

    def cell_files(name, spec=None):
        if name != CELL["name"]:
            return found(name, spec)
        return (CELL, load("configs", f"{CELL['config']}.json"),
                {**load("traffic", f"{CELL['traffic']}.json"), **SMALL},
                load("limits", f"{LIMITS}.json"))

    monkeypatch.setattr(harness, "cell_files", cell_files)


def wrong_salt(monkeypatch):
    """The program draws its poles in the step under the first draw's
    salt."""
    monkeypatch.setattr(program_rider, "_SALT_POLES",
                        program_rider._SALT_INIT)


def float64_draws(monkeypatch):
    """The reference draws its uniforms (and so its normals) in float64
    where the configuration draws in float32."""
    monkeypatch.setattr(rnd, "uniform",
                        lambda key, shape, dtype=torch.float32, lo=0.0,
                        hi=1.0: uniform(key, shape, torch.float64, lo,
                                        hi).to(dtype))


DRAW_FAULTS = [wrong_salt, float64_draws]


def run(monkeypatch, seed=2 ** 32 + 17):
    torch.set_num_threads(4)
    result, lines = harness.run_cell(CELL["name"], seed, 0.5, False, "cpu")
    assert lines[-1].startswith(list(result["checks"])[-1])
    return result


def test_sound_run_is_correct(monkeypatch, small_cell):
    result = run(monkeypatch)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", sum(FAULTS.values(), []),
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch, small_cell):
    where = next(k for k, v in FAULTS.items() if fault in v)
    monkeypatch.setattr(Engine, where, fault)
    result = run(monkeypatch)
    assert result["correct"] is False
    if fault is few_rows_altered:
        assert (result["checks"]["far_rows"]["value"]
                > result["checks"]["far_rows"]["limit"])
    if fault is pairs_left_out:
        assert (result["checks"]["failed_chunks"]["value"]
                > result["checks"]["failed_chunks"]["limit"])


@pytest.mark.parametrize("fault", DRAW_FAULTS, ids=lambda f: f.__name__)
def test_draw_fault_is_not_correct(fault, monkeypatch, small_cell):
    fault(monkeypatch)
    assert run(monkeypatch)["correct"] is False


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)], indirect=True)
def test_control_fails_the_limits(device, small_cell):
    torch.set_num_threads(4)
    limits = harness.cell_files(CELL["name"])[3]["checks"]
    got = control.readings(CELL["name"], 2 ** 31 + 5, 0.5, True, device)
    assert got["correct"] is True
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got[control.CONTROL][k] > v for k, v in limits.items()
               if k in got[control.CONTROL])
