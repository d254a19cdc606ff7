"""A run driven through the whole harness on the CPU at a small size (no
look for a card), with the timed path broken underneath: `correct` comes
out false for each fault a cell of this benchmark can have, and true
without one. The cells run on one chip, so there is no exchange between
chips to leave out."""

import dataclasses

import pytest
import torch

from benchmark import harness
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


FAULTS = {"simulate": [unchanged, half_left_out, answer_altered,
                       few_rows_altered],
          "neighbor_cache": [pairs_left_out]}


def run(cell, monkeypatch, fault=None):
    torch.set_num_threads(4)
    if fault is not None:
        where = next(k for k, v in FAULTS.items() if fault in v)
        monkeypatch.setattr(Engine, where, fault)
    result, lines = harness.run_cell(cell, 2 ** 32 + 17, 0.5, False, "cpu")
    assert lines[-1].startswith(list(result["checks"])[-1])
    return result


@pytest.mark.parametrize("cell", ["bicycle2d-dense-100k",
                                  "balancingrider-dense-100k"])
def test_sound_run_is_correct(cell, monkeypatch, small_crowd):
    result = run(cell, monkeypatch)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", sum(FAULTS.values(), []),
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["bicycle2d-dense-100k",
                                  "balancingrider-dense-100k"])
def test_fault_is_not_correct(cell, fault, monkeypatch, small_crowd):
    result = run(cell, monkeypatch, fault)
    assert result["correct"] is False
    if fault is few_rows_altered:
        assert (result["checks"]["far_rows"]["value"]
                > result["checks"]["far_rows"]["limit"])
    if fault is pairs_left_out:
        assert (result["checks"]["failed_chunks"]["value"]
                > result["checks"]["failed_chunks"]["limit"])
