"""A configuration's `reference_model` and the global step's advance
change nothing for the configurations without them: each of the four
picks the module of its `model`, the comparison reads the same fields
of a program state, the roofline counts the same operations a rider,
and a reference step advances t_glob only where the state has it, the
ring's slot that of the step after. The stochastic rider's
configuration picks its own module."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import step as R
from benchmark.roofline import step as roofline_step

# per configuration: the reference module, the fields it adds to the
# comparison's, and the float32 operations a rider before the key
OLD = {"bicycle2d_twod": ("bicycle2d", (), 460),
       "balancingrider_poly": ("balancingrider", (), 560),
       "twod_spline": ("twod", ("pos_hist", "t_glob"), 1250)}
CELLS = {"bicycle2d-dense-100k": "bicycle2d_twod",
         "bicycle2d-district-8k": "bicycle2d_twod",
         "balancingrider-dense-100k": "balancingrider_poly",
         "twod-routes-100k": "twod_spline"}


@pytest.mark.parametrize("cell", list(CELLS))
def test_old_configurations_pick_their_model(cell):
    _, cfg, mix, _ = harness.cell_files(cell)
    module, extra, ops = OLD[CELLS[cell]]
    assert "reference_model" not in cfg
    assert R.reference_model(cfg) == cfg["model"] == module
    assert R.extra_fields(module) == extra
    c = R.constants(cfg, torch.float64, "cpu")
    assert c["model"] == module
    assert roofline_step.OPS_PER_RIDER[module] == ops
    ctx = {"config": cfg, "steps": 10, "n_active": 7, "rows": 8,
           "pairs": 100.0}
    assert roofline_step.fp32_ops(ctx) == (100.0 * 72 + 10 * 7 * ops)
    inputs = harness.generate({**mix, "n_riders": 64}, 11)
    _, state = harness.build_program(cfg, inputs, "cpu")
    got = harness.reference_input(state, torch.float64,
                                  R.reference_model(cfg))
    assert tuple(got) == harness.STATE_FIELDS + extra


def test_stochastic_configuration_picks_its_own():
    cfg = harness.load_json(harness.BENCH / "configs"
                            / "balancingrider_stochastic.json")
    assert cfg["model"] == "balancingrider"
    assert R.reference_model(cfg) == "balancingrider_stochastic"
    assert R.extra_fields(R.reference_model(cfg)) == ("key", "uid",
                                                      "t_glob")
    assert R.constants(cfg, torch.float64, "cpu")["model"] == \
        "balancingrider_stochastic"
    ctx = {"config": cfg, "steps": 10, "n_active": 7, "rows": 8,
           "pairs": 100.0}
    assert roofline_step.fp32_ops(ctx) == 100.0 * 72 + 10 * 7 * 2740


def small_state(cell, n=64):
    if cell in CELLS:
        _, cfg, mix, _ = harness.cell_files(cell)
    else:
        cfg = harness.load_json(harness.BENCH / "configs"
                                / f"{cell}.json")
        mix = harness.load_json(harness.BENCH / "traffic"
                                / "dense_100k.json")
    inputs = harness.generate({**mix, "n_riders": n}, 5)
    c = R.constants(cfg, torch.float64, "cpu")
    return c, R.initial_state(cfg, c, inputs["s0"], inputs["dest"],
                              inputs["n_riders"], torch.float64, "cpu",
                              inputs.get("waypoints"))


def test_global_step_advances_where_the_state_has_it():
    # no t_glob: nothing added
    c, st = small_state("balancingrider-dense-100k")
    assert set(R.step(st, c)) == set(st)
    # t_glob without a ring: it advances, no ring appears
    c, st = small_state("balancingrider_stochastic")
    assert "pos_hist" not in st and int(st["t_glob"]) == 0
    out = R.run(st, c, 3)
    assert set(out) == set(st) and int(out["t_glob"]) == 3
    # with a ring: slot (t_glob + 1) % H takes the positions after the
    # step, and t_glob advances once
    c, st = small_state("twod-routes-100k")
    st = {**st, "t_glob": torch.tensor(126, dtype=torch.int32)}
    out = R.step(st, c)
    assert int(out["t_glob"]) == 127
    assert torch.equal(out["pos_hist"][:, 127], out["s"][:, :2])
    assert torch.equal(out["pos_hist"][:, :127], st["pos_hist"][:, :127])
    out = R.step(out, c)
    assert int(out["t_glob"]) == 128
    assert torch.equal(out["pos_hist"][:, 0], out["s"][:, :2])
