"""A run driven through the whole harness on the CPU at a small size (no
look for a card), with the timed path broken underneath: `correct` comes
out false for each fault a cell of this benchmark can have, and true
without one; for the twod cell also the spline destination force's
faults: the straight line in its place, and the position ring read one
slot off. The cells run on one chip, so there is no exchange between
chips to leave out."""

import dataclasses

import pytest
import torch

from benchmark import harness
from cyclistsocialforce_tpu_torch import engine as E
from cyclistsocialforce_tpu_torch.engine import Engine, build_neighbor_cache

SMALL = {"n_riders": 600, "episode_steps": 40, "chunk_steps": 20}
simulate = Engine.simulate


def unchanged(self, state, n_steps, **kw):
    """A step that returns its state unchanged."""
    return state, None


def half_left_out(self, state, n_steps, **kw):
    """Half of the batch left out: the second half of the rows keeps its
    input state."""
    out, rec = simulate(self, state, n_steps, **kw)
    h = state.n // 2
    return out.replace(s=torch.cat([out.s[:h], state.s[h:]])), rec


def answer_altered(self, state, n_steps, **kw):
    """Answers altered where they are produced: the rows of one receiver
    block (128) handed the next block's states."""
    out, rec = simulate(self, state, n_steps, **kw)
    s = out.s.clone()
    s[:128], s[128:256] = out.s[128:256], out.s[:128]
    return out.replace(s=s), rec


def few_rows_altered(self, state, n_steps, **kw):
    """Answers altered where they are produced, in four rows only: each
    put 10 m off its position."""
    out, rec = simulate(self, state, n_steps, **kw)
    s = out.s.clone()
    s[5:9, 0] += 10.0
    return out.replace(s=s), rec


def pairs_left_out(self, state):
    """Pairs inside the cutoff left out: a neighbor table of two source
    blocks, which overflows and drops the farther ones."""
    return build_neighbor_cache(dataclasses.replace(self.neighbors, kb=2),
                                state)


def straight_force(self, state, params=None):
    """The straight-line destination force in the spline's place."""
    return E.dest_force_straight(self.params if params is None else params,
                                 state)


ring_row = E._ring_row


def stale_ring(pos_hist, step):
    """The position ring read one slot off: the slot after the one asked
    for (one step back reads the current position)."""
    return ring_row(pos_hist, step + 1)


FAULTS = {"simulate": [unchanged, half_left_out, answer_altered,
                       few_rows_altered],
          "neighbor_cache": [pairs_left_out]}
# the spline destination force's faults (twod), and where they are planted
SPLINE_FAULTS = {straight_force: (Engine, "destination_forces"),
                 stale_ring: (E, "_ring_row")}
CELLS = ["bicycle2d-dense-100k", "balancingrider-dense-100k",
         "twod-routes-100k"]


def run(cell, monkeypatch, fault=None):
    torch.set_num_threads(4)
    if fault in SPLINE_FAULTS:
        monkeypatch.setattr(*SPLINE_FAULTS[fault], fault)
    elif fault is not None:
        where = next(k for k, v in FAULTS.items() if fault in v)
        monkeypatch.setattr(Engine, where, fault)
    result, lines = harness.run_cell(cell, 2 ** 32 + 17, 0.5, False, "cpu")
    assert lines[-1].startswith(list(result["checks"])[-1])
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch, small_crowd):
    result = run(cell, monkeypatch)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", sum(FAULTS.values(), []),
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch, small_crowd):
    result = run(cell, monkeypatch, fault)
    assert result["correct"] is False
    if fault is few_rows_altered:
        assert (result["checks"]["far_rows"]["value"]
                > result["checks"]["far_rows"]["limit"])
    if fault is pairs_left_out:
        assert (result["checks"]["failed_chunks"]["value"]
                > result["checks"]["failed_chunks"]["limit"])


@pytest.mark.parametrize("fault", list(SPLINE_FAULTS),
                         ids=lambda f: f.__name__)
def test_spline_fault_is_not_correct(fault, monkeypatch, small_crowd):
    result = run("twod-routes-100k", monkeypatch, fault)
    assert result["correct"] is False
