"""Structure-of-arrays agent state of the PyTorch port.

Counterpart of `cyclistsocialforce_tpu.state`: one dataclass of
``[N, ...]`` tensors with the same fields, shapes and dtypes (int32
counters, bool `znav`/`active`, a 0-d int32 `t_glob`) and the master
random key `key`, a [2] int64 tensor holding JAX's two uint32 words: the
stochastic balancing rider draws from it through `agent_streams`
(`ops.random`, JAX's threefry streams bit for bit).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.ops import random as rnd
from cyclistsocialforce_tpu_torch.utils.angles import limit_angle

# unified state-vector layout (superset of all models):
#   s[:, 0] x [m]  s[:, 1] y [m]  s[:, 2] psi [rad]  s[:, 3] v [m/s]
#   s[:, 4] delta (steer) [rad]  s[:, 5] theta (roll) [rad]
#   s[:, 6] delta-rate [rad/s]   s[:, 7] theta-rate [rad/s]
STATE_DIM = 8

X, Y, PSI, V, DELTA, THETA, DDELTA, DTHETA = range(8)


@dataclass(frozen=True)
class AgentState:
    s: torch.Tensor              # [N, 8] float
    dyn_x: torch.Tensor          # [N, w] float, model-dependent latents
    dyn_v: torch.Tensor          # [N] float
    dyn_gains: torch.Tensor      # [N, w] float
    pid_e: torch.Tensor          # [N, 2] float: steer, speed loop errors
    pid_i: torch.Tensor          # [N, 2] float: integral accumulators
    dest: torch.Tensor           # [N, 3] float (x, y, stop flag)
    destqueue: torch.Tensor      # [N, Q, 3] float
    destpointer: torch.Tensor    # [N] int32
    nq: torch.Tensor             # [N] int32, valid queue entries
    znav: torch.Tensor           # [N, 3] bool (cruising, stopping, arrived)
    znavparams: torch.Tensor     # [N, 4] float (v0, d0, d1, i_set)
    i_stopsignal: torch.Tensor   # [N] int32
    d_stopsignal: torch.Tensor   # [N] float
    zrid: torch.Tensor           # [N, w] bool (riding, walking)
    walk_ok_steps: torch.Tensor  # [N] int32
    i: torch.Tensor              # [N] int32 step counter
    t_glob: torch.Tensor         # [] int32 global step clock
    pos_hist: torch.Tensor       # [N, H, 2] float; slot t % H = pos @ t
    active: torch.Tensor         # [N] bool
    uid: torch.Tensor            # [N] int32 persistent agent identity
    key: torch.Tensor            # [2] int64 master random key (constant:
    #                              draws derive from t_glob and uid)

    @property
    def n(self) -> int:
        return self.s.shape[0]

    @property
    def hist_len(self) -> int:
        return self.pos_hist.shape[1]

    @property
    def queue_size(self) -> int:
        return self.destqueue.shape[1]

    @property
    def device(self) -> torch.device:
        return self.s.device

    def replace(self, **kw) -> "AgentState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "AgentState":
        return self.replace(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


# default widths of the model-dependent internal fields (the most any
# model of the JAX package needs); make_state(model=...) right-sizes them
_DEFAULT_WIDTHS = {"dyn_x": 7, "dyn_gains": 12, "zrid": 2}


def make_state(s0, queue_size: int = 16, hist_len: int = 128,
               v_max_walk=None, dtype=torch.float32, seed: int = 0,
               model=None, device="cuda") -> AgentState:
    """Create an AgentState population from initial states (the JAX
    package's parameters in its order, then `device`).

    s0 : array-like [N, k], k <= 8, initial (x, y, psi, v[, ...]);
        missing trailing entries are zero-filled.
    queue_size, hist_len : destination-queue capacity Q and position
        ring-buffer length H.
    v_max_walk : optional; initialises the riding/walking FSM from the
        initial speed, otherwise agents start riding.
    seed : the master random key is `jax.random.PRNGKey(seed)`'s.
    model : optional model module; its `STATE_WIDTHS` right-size the
        model-dependent fields (unused ones become zero-width).
    device : where the state lives (the card unless the caller asks for
        the CPU).
    """
    widths = dict(_DEFAULT_WIDTHS)
    if model is not None:
        widths.update(getattr(model, "STATE_WIDTHS", {}))
    s0 = torch.as_tensor(np.asarray(s0), dtype=dtype, device=device)
    if s0.ndim == 1:
        s0 = s0[None]
    n, k = s0.shape
    s = torch.zeros((n, STATE_DIM), dtype=dtype, device=device)
    s[:, :k] = s0
    s[:, PSI] = limit_angle(s[:, PSI])

    dest = torch.cat([s[:, :2], torch.zeros((n, 1), dtype=dtype,
                                            device=device)], dim=1)
    destqueue = torch.zeros((n, queue_size, 3), dtype=dtype, device=device)
    destqueue[:, 0, :] = dest

    znav = torch.zeros((n, 3), dtype=torch.bool, device=device)
    znav[:, 0] = True

    if v_max_walk is not None and widths["zrid"] == 0:
        raise ValueError(
            "v_max_walk initializes the riding/walking FSM, but the "
            "given model declares no zrid state (STATE_WIDTHS['zrid']=0)")
    if widths["zrid"]:
        if v_max_walk is not None:
            walking = s[:, V] < torch.as_tensor(v_max_walk, dtype=dtype,
                                                device=device)
        else:
            walking = torch.zeros((n,), dtype=torch.bool, device=device)
        zrid = torch.stack([~walking, walking], dim=1)
    else:
        zrid = torch.zeros((n, 0), dtype=torch.bool, device=device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return AgentState(
        s=s,
        dyn_x=zeros(n, widths["dyn_x"]),
        dyn_v=s[:, V].clone(),
        dyn_gains=zeros(n, widths["dyn_gains"]),
        pid_e=zeros(n, 2),
        pid_i=zeros(n, 2),
        dest=dest,
        destqueue=destqueue,
        destpointer=zeros(n, dt=torch.int32),
        nq=torch.ones((n,), dtype=torch.int32, device=device),
        znav=znav,
        znavparams=zeros(n, 4),
        i_stopsignal=zeros(n, dt=torch.int32),
        d_stopsignal=zeros(n),
        zrid=zrid,
        walk_ok_steps=zeros(n, dt=torch.int32),
        i=zeros(n, dt=torch.int32),
        t_glob=zeros(dt=torch.int32),
        pos_hist=s[:, None, :2].expand(n, hist_len, 2).clone(),
        active=torch.ones((n,), dtype=torch.bool, device=device),
        uid=torch.arange(n, dtype=torch.int32, device=device),
        key=rnd.key(seed, device),
    )


def agent_streams(key, t_glob, uid, salt: int):
    """Per-agent keys [len(uid), 2], a pure function of (master key, global
    step clock, agent uid, call-site salt), as the JAX package's
    `state.agent_streams` draws them: two folds of the master key (salt,
    then t_glob, a 0-d tensor read on the device), then one per uid. A
    draw keyed so follows its agent through any row permutation."""
    ks = rnd.fold_in(rnd.fold_in(key, salt), t_glob)
    return rnd.fold_in(ks, uid)


def set_destinations(state: AgentState, agent: int, x, y, stop=None,
                     reset: bool = False) -> AgentState:
    """Append (or, with `reset`, reset to) a destination list for one
    agent (reference Vehicle.setDestinations, vehicle.py:606-647).

    `x`, `y`, `stop` are 1-D sequences; `stop` flags stop destinations
    (default all 0). Out of place: returns the new state."""
    def row(v):
        return torch.atleast_1d(torch.as_tensor(
            np.asarray(v, dtype=np.float64), dtype=state.s.dtype,
            device=state.device))

    x, y = row(x), row(y)
    stop = torch.zeros_like(x) if stop is None else row(stop)
    new = torch.stack([x, y, stop], dim=1)
    m = new.shape[0]
    destqueue = state.destqueue.clone()
    nq = state.nq.clone()

    if reset:
        if m > state.queue_size:
            raise ValueError(f"Destination list ({m}) exceeds queue size "
                             f"({state.queue_size}).")
        destqueue[agent] = 0
        destqueue[agent, :m] = new
        destpointer = state.destpointer.clone()
        destpointer[agent] = 0
        nq[agent] = m
        dest = state.dest.clone()
        dest[agent] = new[0]
        return state.replace(destqueue=destqueue, destpointer=destpointer,
                             nq=nq, dest=dest)

    start = int(state.nq[agent])
    if start + m > state.queue_size:
        raise ValueError(f"Destination queue overflow: {start}+{m} > "
                         f"{state.queue_size}.")
    destqueue[agent, start:start + m] = new
    nq[agent] = start + m
    return state.replace(destqueue=destqueue, nq=nq)


def set_spline_destinations(state: AgentState, agent: int, x, y,
                            npoints: int, stop: bool = False,
                            reset: bool = False) -> AgentState:
    """Set intermediate destinations along a cubic spline through the
    given waypoints, starting at the agent's current position (reference
    Vehicle.setSplineDestinations, vehicle.py:649-693); the resampling is
    `trajectory.generate_spline_prototype`. `stop` flags the last one as a
    stop destination. Out of place: returns the new state."""
    from cyclistsocialforce_tpu_torch.trajectory import \
        generate_spline_prototype

    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if x.size < 3:
        raise ValueError(
            "Provide at least 3 points to calculate a cubic trajectory "
            "prototype")
    x = np.insert(x, 0, float(state.s[agent, X]))
    y = np.insert(y, 0, float(state.s[agent, Y]))
    xi, yi = generate_spline_prototype(x, y, npoints)
    flags = np.zeros_like(xi)
    if stop:
        flags[-1] = 1.0
    return set_destinations(state, agent, xi, yi, stop=flags, reset=reset)


def stop(state: AgentState, agent: int, stoptype: int = 0, stopdest=None,
         a_brake=None) -> AgentState:
    """Make one agent come to a halt (reference vehicle.py:459-503). Out
    of place: returns the new state.

    stoptype 0: flag the current destination as a stop destination.
    stoptype 1: emergency stop at the projected braking point; needs
        `a_brake` (params.a_max[0]).
    stoptype 2: stop at the given location `stopdest`.
    """
    dest = state.dest.clone()
    if stoptype == 0:
        dest[agent, 2] = 1.0
        return state.replace(dest=dest)
    if stoptype not in (1, 2):
        raise ValueError("Stop type has to be one of [0,1,2].")
    if stoptype == 1:
        if a_brake is None:
            raise ValueError("Provide a_brake (params.a_max[0]).")
        v = state.s[agent, V]
        tstop = torch.abs(v / a_brake)
        dstop = 1.1 * (v * tstop + 0.5 * a_brake * tstop**2)
        # reference quirk (vehicle.py:491-492): sin for x, cos for y
        dest[agent, 0] = state.s[agent, X] + dstop * torch.sin(
            state.s[agent, PSI])
        dest[agent, 1] = state.s[agent, Y] + dstop * torch.cos(
            state.s[agent, PSI])
    else:
        dest[agent, 0] = float(stopdest[0])
        dest[agent, 1] = float(stopdest[1])
    dest[agent, 2] = 1.0
    destpointer = state.destpointer.clone()
    destpointer[agent] = torch.clamp(state.destpointer[agent] - 1, min=0)
    return state.replace(dest=dest, destpointer=destpointer)


def go(state: AgentState, agent: int, gotype: int = 0) -> AgentState:
    """Continue after a stop (reference vehicle.py:505-535): gotype 0
    clears the stop flag of the current destination, gotype 1 takes the
    current queue entry as the destination again. Out of place."""
    dest = state.dest.clone()
    if gotype == 0:
        dest[agent, 2] = 0.0
    elif gotype == 1:
        dest[agent] = state.destqueue[agent, state.destpointer[agent].long()]
    else:
        raise ValueError("Go type has to be one of [0,1].")
    return state.replace(dest=dest)
