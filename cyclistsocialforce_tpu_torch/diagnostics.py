"""Runtime diagnostics: non-finite and overflow checks, state validation,
profiling.

Counterpart of `cyclistsocialforce_tpu.diagnostics`. The reference fails
by print-and-raise inside its Python loop (the NaN trap vehicle.py:
1180-1185, the solver's RuntimeError dynamics.py:696-698, the FSM
invariant print vehicle.py:416-425). The JAX package turns those into
`checkify` errors; here they are explicit torch checks:

  - `checked_step` / `checked_simulate`: each step tests its neighbor
    table for overflow, its social forces and its new state for finite
    values, and notes the first failing step of each check on the device;
    the run reads the notes back once, at its end, and its error names
    the first failing step (`CheckError.throw`). The normal step loop
    (`Engine.simulate`) carries no check and reads nothing back;
  - `validate_state`: host-side invariants of an AgentState (finite
    values, a one-hot navigation FSM, queue bounds);
  - `trace`: a `torch.profiler` context writing a TensorBoard trace of a
    block of work.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch


class CheckFailed(RuntimeError):
    """A failed runtime check of `checked_step` / `checked_simulate`."""


class CheckError:
    """The outcome of a checked run: `message` is None when every check
    held; `throw()` raises CheckFailed with it otherwise (the JAX
    package's checkify error has the same `get` and `throw`)."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self):
        if self.message is not None:
            raise CheckFailed(self.message)


# the checks of one step, in the order a step runs them
_CHECKS = (
    "neighbor-block table overflow at step {i}: more source blocks within "
    "the cutoff than kb, the farthest dropped and the forces truncated; "
    "raise NeighborConfig.kb",
    "non-finite social force at step {i}",
    "non-finite state at step {i}",
)


def _checked_step(engine, state, step, first):
    """One step of `engine` with the three checks; `first` [3] int64 on
    the device holds each check's first failing step (-1: none yet) and
    is updated in place. Returns the new state."""
    engine.check_state(state)
    cache = None
    bad = []
    if engine.neighbors is not None:
        cache = engine.neighbor_cache(state)
        bad.append(cache[3].any())
    else:
        bad.append(torch.zeros((), dtype=torch.bool, device=state.device))
    fx, fy, st = engine.calc_forces(state, cache)
    bad.append(~(torch.isfinite(fx) & torch.isfinite(fy)).all())
    new = engine.dynamics(st, fx, fy)
    bad.append(~torch.isfinite(new.s).all())
    first.copy_(torch.where((first < 0) & torch.stack(bad), step, first))
    return engine.finish_step(state, new), new.s


def _error(first) -> CheckError:
    """The error of the earliest failing step (one read of the notes)."""
    notes = first.tolist()
    failed = [(i, k) for k, i in enumerate(notes) if i >= 0]
    if not failed:
        return CheckError()
    i, k = min(failed)
    return CheckError(_CHECKS[k].format(i=i))


def checked_step(engine):
    """One engine step with the checks: a function state -> (error, new
    state)."""
    def step(state):
        first = torch.full((len(_CHECKS),), -1, dtype=torch.int64,
                           device=state.device)
        new, _ = _checked_step(engine, state, 0, first)
        return _error(first), new

    return step


def checked_simulate(engine, n_steps: int):
    """`n_steps` checked steps, each building its own neighbor table as
    the JAX package's checked scan does: a function state -> (error,
    (final state, [T, N, 8] recorded states)). The error names the first
    failing step."""
    def run(state):
        first = torch.full((len(_CHECKS),), -1, dtype=torch.int64,
                           device=state.device)
        traj = torch.empty((n_steps, state.n, state.s.shape[1]),
                           dtype=state.s.dtype, device=state.device)
        for i in range(n_steps):
            state, traj[i] = _checked_step(engine, state, i, first)
        return _error(first), (state, traj)

    return run


def validate_state(state) -> list:
    """Host-side invariant scan; returns a list of violation strings."""
    def host(t):
        return t.detach().cpu().numpy()

    problems = []
    s = host(state.s)
    if not np.all(np.isfinite(s)):
        bad = np.where(~np.isfinite(s).all(axis=1))[0]
        problems.append(f"non-finite state rows: {bad[:10].tolist()}")
    znav = host(state.znav)
    multi = znav.sum(axis=1) > 1
    if np.any(multi & host(state.active)):
        # the reference prints exactly this invariant violation
        # (vehicle.py:416-425)
        problems.append(
            f"navigation FSM in multiple states: rows "
            f"{np.where(multi)[0][:10].tolist()}")
    ptr = host(state.destpointer)
    nq = host(state.nq)
    if np.any(ptr > nq):
        problems.append("destination pointer beyond queue length")
    if np.any(nq > state.queue_size):
        problems.append("queue length beyond capacity")
    return problems


@contextlib.contextmanager
def trace(logdir=None):
    """Profile a block of work with `torch.profiler` (the card's kernels
    too where there is one) and write a TensorBoard trace to `logdir`
    (default: csf-torch-trace in the temporary directory): `with
    trace() as d: run(...)`."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "csf-torch-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)):
        yield logdir
