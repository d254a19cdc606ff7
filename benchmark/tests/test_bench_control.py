"""The control of `correct`: the reference computed in bfloat16, the
precision below the configurations' float32, put in the program's place.
At this test's size it fails the limits of every cell, where the
program's own float32 run passes them. `benchmark/control.py` takes the
same readings at the cells' own sizes on the card."""

import pytest
import torch

from benchmark import control, harness

SMALL = {"n_riders": 600, "episode_steps": 200, "chunk_steps": 100}


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)], indirect=True)
@pytest.mark.parametrize("cell", ["bicycle2d-dense-100k",
                                  "balancingrider-dense-100k",
                                  "bicycle2d-district-8k",
                                  "twod-routes-100k"])
def test_control_fails_the_limits(cell, device, small_crowd):
    torch.set_num_threads(4)
    limits = harness.cell_files(cell)[3]["checks"]
    got = control.readings(cell, 2 ** 31 + 5, 0.5, True, device)
    assert got["correct"] is True
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got[control.CONTROL][k] > v for k, v in limits.items()
               if k in got[control.CONTROL])
