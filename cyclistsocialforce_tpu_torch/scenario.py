"""Scenario runner: the simulation loop, pacing, metrics, checkpoints.

Counterpart of `cyclistsocialforce_tpu.scenario` (reference
scenario.py:53-265). The population stays on the device and advances in
CHUNKS, one `Engine.simulate` call each (on the card every
`rebuild_every`-step piece of it one CUDA-graph replay); the host sees the
state only between chunks, for callbacks, pacing, metrics and
checkpoints.

  - run modes: the reference's silent and animated modes become
    `run(..., callback=...)`, the callback taking (step_index, state,
    traj_chunk) after every chunk;
  - real-time pacing: a per-step budget `t_s / run_time_factor`
    (reference scenario.py:59-77, 175-195), applied per chunk;
  - metrics: wall time per chunk, steps/s and agent-steps/s (the
    reference's `hist_run_time`, scenario.py:457-463), a chunk's wall time
    read after one `torch.cuda.synchronize` at its end;
  - checkpoints: `save_checkpoint` / `load_checkpoint` write and read the
    JAX package's npz layout (one `leaf<path>` array per leaf, JAX's
    `keystr` path, and a `__meta__` JSON blob), so a state saved by
    either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.state import AgentState

# --------------------------------------------------------------------------
# checkpoints: a tree of tensors <-> npz
# --------------------------------------------------------------------------


def _leaves(tree, path=""):
    """(path, leaf) pairs of a tree of dataclasses, tuples, lists, dicts
    and arrays, the paths in `jax.tree_util.keystr` form (".field",
    "[0]", "['key']"); None is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for f in dataclasses.fields(tree)
                for pair in _leaves(getattr(tree, f.name),
                                    f"{path}.{f.name}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in _leaves(v, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _leaves(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _rebuild(template, values, path=""):
    """`template` with each leaf replaced by values[its path]."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template) and not isinstance(template,
                                                             type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), values,
                             f"{path}.{f.name}")
            for f in dataclasses.fields(template) if f.init})
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, values, f"{path}[{i}]")
                              for i, v in enumerate(template))
    if isinstance(template, dict):
        return {k: _rebuild(template[k], values, f"{path}[{k!r}]")
                for k in template}
    return values[path]


def _to_numpy(path, leaf):
    """A leaf as the JAX package stores it: the master key's two words as
    uint32 (the port holds them in int64)."""
    arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
           else np.asarray(leaf))
    if path.endswith(".key") and arr.dtype == np.int64:
        arr = arr.astype(np.uint32)
    return arr


def save_checkpoint(path, state, extra: dict | None = None):
    """Save a simulation state (an AgentState, or any tree of
    dataclasses, tuples, lists and dicts over tensors) and optional host
    metadata to one .npz file, in the JAX package's layout. Resume with
    `load_checkpoint(path, template)`."""
    data = {f"leaf{k}": _to_numpy(k, v) for k, v in _leaves(state)}
    data["__meta__"] = np.frombuffer(json.dumps(extra or {}).encode(),
                                     dtype=np.uint8)
    np.savez_compressed(path, **data)


def load_checkpoint(path, template):
    """Restore a state saved by `save_checkpoint` (of either package);
    `template` gives the structure and each leaf's dtype and device (e.g.
    a freshly built AgentState of the same shapes).

    Returns (state, extra metadata dict)."""
    values = {}
    with np.load(path) as data:
        for key, like in _leaves(template):
            arr = np.asarray(data[f"leaf{key}"])
            if isinstance(like, torch.Tensor):
                if tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(
                        f"checkpoint leaf {key} has shape {arr.shape}, the "
                        f"template {tuple(like.shape)}")
                np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
                values[key] = torch.from_numpy(arr.astype(np_dtype)).to(
                    like.device)
            else:
                values[key] = arr
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    return _rebuild(template, values), meta


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


class RuntimeMetrics:
    """Host-side runtime history per chunk (reference hist_run_time and
    plot_runtime_vs_nvec, scenario.py:457-543)."""

    def __init__(self):
        self.chunk_steps: list[int] = []
        self.chunk_wall: list[float] = []
        self.n_agents: list[int] = []

    def record(self, n_steps, wall, n_agents):
        self.chunk_steps.append(int(n_steps))
        self.chunk_wall.append(float(wall))
        self.n_agents.append(int(n_agents))

    @property
    def total_steps(self):
        return int(np.sum(self.chunk_steps))

    @property
    def total_wall(self):
        return float(np.sum(self.chunk_wall))

    def steps_per_sec(self):
        return self.total_steps / max(self.total_wall, 1e-12)

    def agent_steps_per_sec(self):
        total = np.sum(np.asarray(self.chunk_steps)
                       * np.asarray(self.n_agents))
        return float(total) / max(self.total_wall, 1e-12)

    def step_wall_times(self):
        """Mean wall time per step of each chunk [s]."""
        return (np.asarray(self.chunk_wall)
                / np.maximum(np.asarray(self.chunk_steps), 1))

    def summary(self):
        return {
            "total_steps": self.total_steps,
            "total_wall_s": round(self.total_wall, 4),
            "steps_per_sec": round(self.steps_per_sec(), 1),
            "agent_steps_per_sec": round(self.agent_steps_per_sec(), 1),
        }

    def plot_runtime(self, t_s=0.01, ax=None):
        """Wall time per step against the agent count, with the real-time
        line (reference plot_runtime_vs_nvec, scenario.py:484-543)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        ax.scatter(self.n_agents, self.step_wall_times() * 1e3,
                   s=12, label="measured")
        ax.axhline(t_s * 1e3, color="red", linestyle="--",
                   label=f"real-time requirement ({t_s * 1e3:.0f} ms)")
        ax.set_xlabel("number of agents")
        ax.set_ylabel("wall time per step [ms]")
        ax.set_yscale("log")
        ax.legend()
        return ax


# --------------------------------------------------------------------------
# the scenario runner
# --------------------------------------------------------------------------


class Scenario:
    """Standalone simulation scenario (reference Scenario,
    scenario.py:53-265).

    engine : the interaction engine (`Engine`, `MixedEngine`).
    state : the initial population state; its device is where the
        scenario runs.
    t_s : simulation step [s] (pacing, and `run(t_end=)`).
    chunk : steps per `Engine.simulate` call. Larger chunks amortise the
        host's part; chunk=1 is the reference's per-step loop.
    run_time_factor : None runs as fast as possible, 1.0 in real time, 2.0
        twice as fast (reference scenario.py:59-77, 293-297).
    """

    def __init__(self, engine, state: AgentState, t_s: float = 0.01,
                 chunk: int = 100, run_time_factor: float | None = None):
        self.engine = engine
        self.state0 = state
        self.state = state
        self.t_s = float(t_s)
        self.chunk = int(chunk)
        self.run_time_factor = run_time_factor
        self.metrics = RuntimeMetrics()
        self.i = 0

    def step_chunk(self, n_steps: int | None = None, record: bool = True):
        """Advance by one chunk (one `Engine.simulate` call); returns the
        recorded [chunk, N, 8] states, or None. The chunk's wall time,
        read after the device has finished it, goes to `metrics`."""
        n_steps = n_steps or self.chunk
        t0 = time.perf_counter()
        self.state, traj = self.engine.simulate(self.state, n_steps,
                                                record=record)
        if self.state.device.type == "cuda":
            torch.cuda.synchronize(self.state.device)
        self.metrics.record(n_steps, time.perf_counter() - t0, self.state.n)
        self.i += n_steps
        return traj

    def run(self, t_end: float | None = None, n_steps: int | None = None,
            callback: Callable | None = None, record: bool = False):
        """Run for `t_end` seconds of simulated time (or `n_steps` steps).

        callback(i, state, traj_chunk) fires after every chunk; with
        record=True the whole [T, N, 8] trajectory is returned as a numpy
        array."""
        if n_steps is None:
            if t_end is None:
                raise ValueError("pass t_end or n_steps")
            n_steps = int(round(t_end / self.t_s))
        out = []
        done = 0
        while done < n_steps:
            n = min(self.chunk, n_steps - done)
            traj = self.step_chunk(n, record=record or callback is not None)
            done += n
            if record:
                out.append(traj.cpu().numpy())
            if callback is not None:
                callback(self.i, self.state, traj)
            self._pace(n)
        if record:
            return np.concatenate(out, axis=0)
        return None

    def _pace(self, n_steps):
        """Sleep to hold the requested real-time factor (reference _wait,
        scenario.py:175-195)."""
        if self.run_time_factor is None:
            return
        budget = n_steps * self.t_s / self.run_time_factor
        spent = self.metrics.chunk_wall[-1]
        if spent < budget:
            time.sleep(budget - spent)

    def reset(self):
        """Rewind to the initial state, the whole of it (reference
        Scenario.reset rewinds the counters only, scenario.py:226-229)."""
        self.state = self.state0
        self.i = 0
        self.metrics = RuntimeMetrics()

    def checkpoint(self, path):
        save_checkpoint(path, self.state, extra={"i": self.i,
                                                 "t_s": self.t_s})

    def restore(self, path):
        self.state, meta = load_checkpoint(path, self.state)
        self.i = int(meta.get("i", 0))
        return meta
