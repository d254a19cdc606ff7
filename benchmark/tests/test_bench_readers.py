"""The per-layer readers on a trace summary made by hand."""

import pytest

from benchmark import harness
from benchmark.roofline import agent_step, pair_forces

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CFG = harness.cell_files("bicycle2d-dense-100k", SPEC)[1]


def ctx(**kw):
    base = {"config": CFG, "steps": 1000, "rows": 100096,
            "n_active": 100000, "n_next": 0, "hist_len": 8,
            "pairs": 1.6e10, "busy_us": 330e3, "window_us": 380e3,
            "host_calls": {"cudaLaunchKernel": 7000, "cudaGraphLaunch": 50},
            "device_us": {"void pair_forces_twod_kernel<128>(...)": 228e3,
                          "agent_pre_kernel(csf::AgentPreArgs)": 30e3,
                          "agent_post_kernel(csf::AgentPostArgs)": 33e3}}
    return {**base, **kw}


def read(name, c):
    return harness.load_reader(name).read(c)


def test_values():
    c = ctx()
    assert read("pair_ms_per_step", c) == pytest.approx(0.228)
    assert read("agent_kernels_ms_per_step", c) == pytest.approx(0.063)
    assert read("rest_device_ms_per_step", c) == pytest.approx(0.039)
    assert read("host_launches_per_step", c) == pytest.approx(7.05)
    assert read("device_idle_pct", c) == pytest.approx(100 * 50 / 380)
    bound, which = pair_forces.bound_seconds(c)
    assert which == "mufu"
    assert read("pair_forces_roofline", c) == pytest.approx(
        100 * bound / 0.228)
    assert 0 < read("agent_step_roofline", c) < 100
    assert agent_step.bound_seconds(c) > 0
    assert 0 < read("step_mfu", c) < 100


def test_nothing_to_read_gives_nothing():
    c = ctx(device_us={"some_other_kernel": 5.0})
    for name in ("pair_ms_per_step", "pair_forces_roofline",
                 "agent_kernels_ms_per_step", "agent_step_roofline"):
        assert read(name, c) is None
    assert read("pair_forces_roofline", ctx(pairs=None)) is None
