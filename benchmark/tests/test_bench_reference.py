"""The plain reference against the port in float64 on the CPU: the same
steps from the same generated inputs agree to rounding, for every
configuration, from an episode's start and from the port's state later
in it (taken through `harness.reference_input`, as the check follows
the program between chunks). The cutoff is raised past the small
crowd's extent so that both sides sum the same pairs (the port's table
also holds pairs beyond the cutoff, the reference none). The twod
crowd's waypoints lie 2.5 m apart, so that riders reach their last one
within the run and both spline branches are taken; the later start lies
past the ring's length, so that the lookback wraps."""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import step as R
from benchmark.reference import whipple


SHORT_ROUTES = {"waypoint_spacing_m": 2.5, "waypoint_side_m": 0.5}
# steps from the start; steps before the later start; steps from it
START, LATER, AGAIN = 50, 80, 50


def setup(cell, n=300, seed=3):
    _, cfg, mix, _ = harness.cell_files(cell)
    cfg = copy.deepcopy(cfg)
    cfg["dtype"] = "float64"
    cfg["neighbors"].update(cutoff=400.0, kb=64)
    if mix["generator"] == "routes":
        mix = {**mix, **SHORT_ROUTES}
    inputs = harness.generate({**mix, "n_riders": n}, seed)
    return cfg, inputs


@pytest.mark.parametrize("cell", ["bicycle2d-dense-100k",
                                  "balancingrider-dense-100k",
                                  "twod-routes-100k"])
def test_reference_follows_the_port_in_float64(cell):
    torch.set_num_threads(4)
    cfg, inputs = setup(cell)
    engine, state = harness.build_program(cfg, inputs, "cpu")
    c = R.constants(cfg, torch.float64, "cpu")
    ref = R.initial_state(cfg, c, inputs["s0"], inputs["dest"],
                          inputs["n_riders"], torch.float64, "cpu",
                          inputs.get("waypoints"))
    # the start: the port's prepared state is the reference's own
    start = harness.reference_input(state, torch.float64, cfg["model"])
    assert set(ref) <= set(start)
    for key in [k for k in ("s", "dyn_x", "pos_hist", "destqueue")
                if k in ref]:
        assert torch.allclose(start[key], ref[key], rtol=0, atol=1e-12)
    if cell.startswith("balancing"):
        scale = ref["dyn_gains"].abs().amax(dim=1, keepdim=True)
        assert float(((start["dyn_gains"] - ref["dyn_gains"]).abs()
                      / scale).max()) < 1e-8
    out, _ = engine.simulate(state, START, record=False)
    want = R.run(ref, c, START)
    act = want["active"]
    assert float((out.s[act] - want["s"][act]).abs().max()) < 1e-8
    # and from the port's state, as the check follows it between chunks
    later, _ = engine.simulate(out, LATER, record=False)
    again = R.run(harness.reference_input(later, torch.float64, cfg["model"]),
                  c, AGAIN)
    out2, _ = engine.simulate(later, AGAIN, record=False)
    assert float((out2.s[act] - again["s"][act]).abs().max()) < 1e-8
    if "pos_hist" in again:
        assert float((out2.pos_hist[act] - again["pos_hist"][act]).abs()
                     .max()) < 1e-8
        assert int(out2.t_glob) == int(again["t_glob"])
        # riders at their last waypoint, and riders short of it
        last = (again["destpointer"] == again["nq"] - 1)[act]
        assert 0 < int(last.sum()) < int(act.sum())


def test_gains_polynomial_worked_out_again():
    create = harness.cell_files("balancingrider-dense-100k")[1]["create"]
    from cyclistsocialforce_tpu_torch.params import BalancingRiderParams

    prog = BalancingRiderParams.create(**create)
    mats = whipple.system_matrices(create["bicycle_parameter_dict"])
    lin = whipple.pole_features_linear(create["controlparam_filename"])
    assert np.allclose(lin, np.asarray(prog.br_pole_lin), rtol=1e-10,
                       atol=1e-12)
    for got, want in zip(mats, (prog.br_A0, prog.br_A1, prog.br_A2,
                                prog.br_B)):
        assert np.allclose(got, np.asarray(want), rtol=1e-12, atol=1e-14)
    coeffs, lo, seg = whipple.fit_gains_poly(mats, lin, 10.0,
                                             create["gains_poly"])
    theirs, t_lo, t_seg = prog.br_gains_poly
    assert (lo, seg) == (t_lo, t_seg)
    theirs = np.asarray(theirs).reshape(coeffs.shape)
    assert np.allclose(coeffs, theirs, rtol=1e-8,
                       atol=1e-8 * np.abs(theirs).max())
