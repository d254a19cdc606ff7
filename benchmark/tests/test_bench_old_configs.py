"""The hooks the twod configuration brought (a model's `EXTRA_FIELDS`,
the `dest_force` it names, a traffic's `waypoints`) change nothing for
the configurations that have none: the reference reads the same fields
of a program state, and starts from the same state, as before them."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import step as R

# the fields the comparison read from a program state before the hooks
BEFORE = ("s", "dyn_x", "dyn_gains", "pid_e", "pid_i", "dest", "destqueue",
          "destpointer", "nq", "i", "znav", "znavparams", "active")


def initial_state_before(cfg, c, s0, dest, n_riders, dtype, device):
    """`reference.step.initial_state` as it was before the hooks."""
    rows = s0.shape[0]
    q = int(cfg.get("queue_size", 16))
    s = torch.zeros((rows, 8), dtype=torch.float64, device=device)
    s[:, :5] = torch.as_tensor(s0, dtype=torch.float64, device=device)
    s[:, 2] = R.limit_angle(s[:, 2])
    d = torch.zeros((rows, 3), dtype=torch.float64, device=device)
    d[:, :2] = torch.as_tensor(dest, dtype=torch.float64, device=device)
    queue = torch.zeros((rows, q, 3), dtype=torch.float64, device=device)
    queue[:, 0] = d
    st = {
        "s": s, "pid_e": torch.zeros((rows, 2), dtype=torch.float64,
                                     device=device),
        "dest": d, "destqueue": queue,
        "destpointer": torch.zeros(rows, dtype=torch.int32, device=device),
        "nq": torch.ones(rows, dtype=torch.int32, device=device),
        "i": torch.zeros(rows, dtype=torch.int32, device=device),
        "znav": torch.zeros((rows, 3), dtype=torch.bool, device=device),
        "znavparams": torch.zeros((rows, 4), dtype=torch.float64,
                                  device=device),
        "active": torch.arange(rows, device=device) < n_riders,
    }
    st["pid_i"] = st["pid_e"].clone()
    st["znav"][:, 0] = True
    st.update(R.model_of(c["model"]).initial(st, c))
    return R.cast(st, dtype)


@pytest.mark.parametrize("cell", ["bicycle2d-dense-100k",
                                  "balancingrider-dense-100k"])
def test_old_configurations_read_as_before(cell):
    _, cfg, mix, _ = harness.cell_files(cell)
    inputs = harness.generate({**mix, "n_riders": 200}, 2 ** 31 + 3)
    assert "waypoints" not in inputs
    assert R.extra_fields(cfg["model"]) == ()
    engine, state = harness.build_program(cfg, inputs, "cpu")
    assert bool((state.nq == 1).all()) and bool((state.destpointer == 0).all())
    assert not bool(state.destqueue[:, 1:].any())
    got = harness.reference_input(state, torch.float64, cfg["model"])
    assert tuple(got) == BEFORE
    c = R.constants(cfg, torch.float64, "cpu")
    assert R.dest_force_of(c["dest_force"]) is R.destination
    args = (cfg, c, inputs["s0"], inputs["dest"], inputs["n_riders"],
            torch.float64, "cpu")
    now, before = R.initial_state(*args, inputs.get("waypoints")), \
        initial_state_before(*args)
    assert list(now) == list(before)
    for key in before:
        assert now[key].dtype == before[key].dtype
        assert torch.equal(now[key], before[key]), key
    # one step of the reference writes no ring
    assert set(R.step(now, c)) == set(before)
