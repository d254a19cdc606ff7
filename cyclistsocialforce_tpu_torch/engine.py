"""The social-force interaction engine of the PyTorch port.

Counterpart of `cyclistsocialforce_tpu.engine`: one agent population on a
shared space, advanced step by step --

  1. destination force with the destination-queue and navigation-FSM
     updates (`dest_force_straight`, or `dest_force_hm`),
  2. pairwise repulsive forces of the "twod" or "legacy" field: dense
     over all pairs (`Engine.repulsive_sum`, plain PyTorch, as the JAX
     package computes it outside any Pallas kernel), or culled over the
     block-sparse neighbor table (`repulsive_sum_neighbors`, the pair
     kernels of `ops.pair_forces`; the legacy field takes their mixed-
     family form with every row legacy),
  3. repulsive-force magnitude clamp and summation (`ops.forces`),
  4. one dynamics step of every agent (the model's `step`),
  5. bookkeeping: inactive agents frozen, step counters, position ring.

Every stage is a batched function over the [N] agent axis. The culled
pair stage runs its CUDA kernel on CUDA tensors and its plain version on
CPU tensors: the state's device selects the backend.

`Engine.simulate` is the step loop. The JAX package compiles a chunk of
`rebuild_every` steps (its inner `lax.scan`) into one program; the port's
counterpart is `ChunkRunner`, which captures the chunk's steps once as a
CUDA graph over static buffers and replays it per chunk.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from dataclasses import dataclass

import torch
from torch import nn

from cyclistsocialforce_tpu_torch.ops import forces as F
from cyclistsocialforce_tpu_torch.ops import navigation as nav
from cyclistsocialforce_tpu_torch.ops import neighbors as NB
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
from cyclistsocialforce_tpu_torch.params import pair_hi
from cyclistsocialforce_tpu_torch.state import (PSI, STATE_DIM, THETA, V, X,
                                                Y, AgentState)


@dataclass(frozen=True)
class NavParams:
    """The navigation parameters: each a float (or a (min, max) pair)
    shared by the population, or a per-agent [N] (pairs [N, 2]) tensor."""

    d_arrived_inter: object
    d_arrived_stop: object
    v_max_stop: object
    v_max_harddecel: object
    v_desired_default: object
    a_max: object
    a_desired_default: object


def nav_params_view(params, like: torch.Tensor) -> NavParams:
    """The navigation fields, per-agent tensors cast to `like`'s dtype and
    device. Shared values stay Python floats: torch applies them as
    scalars, with no host-to-device copy (which would block the host on
    the device every step)."""
    def view(value):
        if isinstance(value, torch.Tensor):
            return value.to(dtype=like.dtype, device=like.device)
        return value

    return NavParams(**{f: view(getattr(params, f)) for f in (
        "d_arrived_inter", "d_arrived_stop", "v_max_stop",
        "v_max_harddecel", "v_desired_default", "a_max",
        "a_desired_default")})


def dest_force_straight(params, state: AgentState):
    """Destination update, navigation FSM and straight-line force
    (reference vehicle.py:1150-1194). Returns (fx, fy, new_state)."""
    npar = nav_params_view(params, state.s)
    pos = state.s[:, :2]
    dest, ptr, istop, dstop = nav.update_destination(
        pos, state.dest, state.destqueue, state.destpointer, state.nq,
        state.znav, state.i, state.i_stopsignal, state.d_stopsignal,
        npar.d_arrived_inter)
    ddest = nav.dest_distance(pos, state.destqueue, ptr)
    vd, znav, znavp = nav.update_nav_state(
        state.s[:, V], ddest, dest[:, 2], state.znav, state.znavparams,
        state.i, npar)
    fx, fy = F.dest_force_straight(pos[:, 0], pos[:, 1], dest[:, 0],
                                   dest[:, 1], vd, ddest)
    new_state = state.replace(
        dest=dest, destpointer=ptr, znav=znav, znavparams=znavp,
        i_stopsignal=istop, d_stopsignal=dstop)
    return fx, fy, new_state


def _per_agent(value, n: int, like: torch.Tensor):
    """A shared or per-agent [N] parameter as an [N] tensor of `like`'s
    dtype and device (per-agent tables in row order, as the dense stage
    reads them)."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=like.dtype, device=like.device).expand(n)
    return torch.full((n,), float(value), dtype=like.dtype,
                      device=like.device)


def dest_force_hm(params, state: AgentState):
    """Helbing-Molnar destination force (reference
    Bicycle.calcDestinationForceHM, vehicle.py:1196-1216): the whole
    straight-line stage (queue update and navigation FSM), then the
    current velocity relaxed toward `v_desired_default` along the
    straight-line direction (acceleration semantics)."""
    fx, fy, new_state = dest_force_straight(params, state)
    vdd = _per_agent(params.v_desired_default, state.n, state.s)
    fx, fy = F.dest_force_hm(fx, fy, state.s[:, V], state.s[:, PSI], vdd)
    return fx, fy, new_state


DEST_FORCES = {"straight": dest_force_straight,
               "direct": dest_force_straight,
               "hm": dest_force_hm}


def rep_tile_twod(params, src, recv):
    """[S, R] tile of the BMD2023 2D-model field: [i, j] is the force of
    source i at receiver j. `src` and `recv` are (x, y, psi, v) bundles;
    the heading trig stays on the [S] and [R] axes."""
    xs, ys, psis, _ = src
    xr, yr, psir = recv[0], recv[1], recv[2]
    n = xs.shape[0]
    dx = xr[None, :] - xs[:, None]
    dy = yr[None, :] - ys[:, None]

    def b(field):
        return _per_agent(getattr(params, field), n, xs)[:, None]

    return F.rep_force_twod_pair(
        dx, dy, torch.cos(psis)[:, None], torch.sin(psis)[:, None],
        torch.cos(psir)[None, :], torch.sin(psir)[None, :],
        b("f_0"), b("e_0"), b("e_1"), b("sigma_0"), b("sigma_1"),
        b("sigma_2"), b("sigma_3"))


def rep_tile_legacy(params, src, recv):
    """[S, R] tile of the legacy v0.1 elliptic field, its speed-dependent
    excentricity terms computed once per source."""
    xs, ys, psis, vs = src
    xr, yr = recv[0], recv[1]
    n = xs.shape[0]
    dx = xr[None, :] - xs[:, None]
    dy = yr[None, :] - ys[:, None]
    e = F.legacy_excentricity(
        vs.expand(n), _per_agent(pair_hi(params.v_max_riding), n, xs))
    inv_se = 1.0 / torch.sqrt(1 - e**2)
    p_decay = _per_agent(params.p_decay, n, xs)
    p_0 = _per_agent(params.p_0, n, xs)
    return F.rep_force_legacy_pair(
        dx, dy, torch.cos(psis)[:, None], torch.sin(psis)[:, None],
        e[:, None], inv_se[:, None], (1.0 / p_decay)[:, None],
        (p_0 / p_decay)[:, None])


# the named repulsive fields; the name is the engine's pair family
REP_FORCES = {"twod": rep_tile_twod, "legacy": rep_tile_legacy}


# the pair kernels NeighborConfig.backend selects (the JAX package's names)
BACKENDS = ("pallas", "pallas_unrolled", "pallas_db")
# JAX-only backends: the XLA gather path and the Pallas interpreter, whose
# role the plain version plays in the port
JAX_ONLY_BACKENDS = ("xla", "interpret", "interpret_unrolled",
                     "interpret_db")


@dataclass(frozen=True)
class NeighborConfig:
    """Configuration of the block-sparse neighbor force path.

    cutoff : interaction radius [m]; the twod field decays as
        exp(-rho/sigma), sigma <= ~5.5 m, so 50-60 m bounds the dropped
        force near 1e-4. The legacy field needs ~100 m: its forward decay
        is much slower for fast sources.
    block : receivers per block. The CUDA kernels take 128 and raise for
        any other value; CPU tensors (the plain version) take any.
    block_src : sources per block (0: `block`; must divide `block`, and
        be a multiple of 8).
    kb : capacity of the neighbor-block table (overflow drops the
        farthest blocks and is flagged).
    backend : the pair kernel on CUDA tensors: "pallas" (K1,
        `ops.pair_forces.pair_forces_neighbors`), "pallas_unrolled" (K2,
        every source tile staged up front, never screened) or "pallas_db"
        (K3, a ring of tiles, always tile-screened at `cutoff`, needs
        block_src == block). The names are the JAX package's; CPU tensors
        run each kernel's plain version in the same form.
    screen : K1 skips every table tile in which no pair lies within
        `cutoff` (the cutoff without the skin).
    sub : with `screen`, K1 screens strips of `sub` sources instead of
        whole tiles (0: whole tiles; else a multiple of 8 dividing
        block_src).
    rebuild_every : rebuild the sort and table every K steps inside
        `simulate`, with a skin margin on the cutoff covering the
        pairwise drift in between (default 2 * v_max * t_s * K).
    table_chunk : build the neighbor table in chunks of this many
        receiver rows (0: all at once); the same table, with the
        [B, B_src] box-distance matrix (~8 GB at N = 4e6) bounded to
        [table_chunk, B_src].
    rebuild_mode, row_segments : accepted so that a configuration written
        for the JAX package constructs here, validated as there
        ("chunked" or "flat"; >= 1), stored, and without effect: both
        select between TPU mechanisms of the same physics (one flat scan
        with a gated rebuild; the pair call split for the scalar-memory
        budget), which the port has no use for.
    """

    cutoff: float = 60.0
    block: int = 128
    block_src: int = 0
    kb: int = 16
    backend: str = "pallas"
    rebuild_every: int = 1
    skin: float | None = None
    v_max: float = 10.0
    t_s: float = 0.01
    sub: int = 0
    screen: bool = True
    rebuild_mode: str = "chunked"
    table_chunk: int = 0
    row_segments: int = 1

    def __post_init__(self):
        bs = int(self.block_src) or int(self.block)
        if int(self.block) % bs != 0 or bs % 8 != 0:
            raise ValueError(f"block_src ({bs}) must divide block "
                             f"({self.block}) and be a multiple of 8")
        if self.backend not in BACKENDS:
            hint = (" (the port runs each kernel's plain version on CPU "
                    "tensors: pick the kernel by name and put the state on "
                    "the CPU)" if self.backend in JAX_ONLY_BACKENDS else "")
            raise ValueError(f"backend {self.backend!r} is not one of "
                             f"{BACKENDS}{hint}")
        if self.backend == "pallas_db" and bs != int(self.block):
            raise ValueError("the double-buffered backend does not support "
                             "block_src != block; use 'pallas'")
        PF._check_sub(bs, int(self.sub))
        if self.rebuild_mode not in ("chunked", "flat"):
            raise ValueError(f"rebuild_mode must be 'chunked' or 'flat', "
                             f"got {self.rebuild_mode!r}")
        if int(self.row_segments) < 1:
            raise ValueError("row_segments must be >= 1")
        skin = (float(self.skin) if self.skin is not None
                else 2.0 * self.v_max * self.t_s * int(self.rebuild_every))
        set_ = object.__setattr__
        set_(self, "cutoff", float(self.cutoff))
        set_(self, "block", int(self.block))
        set_(self, "block_src", bs)
        set_(self, "kb", int(self.kb))
        set_(self, "rebuild_every", int(self.rebuild_every))
        set_(self, "skin", skin)
        set_(self, "sub", int(self.sub))
        set_(self, "screen", bool(self.screen))
        set_(self, "table_chunk", int(self.table_chunk))
        set_(self, "row_segments", int(self.row_segments))


def _values(params, field):
    v = getattr(params, field)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().double().reshape(-1).tolist()
    return [float(v)]


def _hfov_is_full(params) -> bool:
    """Does every agent's half field of view cover the full circle?"""
    return all(h >= 2.0 * math.pi - 1e-9 for h in _values(params, "hfov"))


def _uniform_pair_params(params):
    """(e_0, e_1, sigma_0..3, cos(hfov/2)) when each twod pair-field
    parameter is one value shared by the population, else None. f_0 is
    not included: its column carries the per-agent emit flag."""
    vals = []
    for f in ("e_0", "e_1", "sigma_0", "sigma_1", "sigma_2", "sigma_3",
              "hfov"):
        flat = _values(params, f)
        if not flat or any(x != flat[0] for x in flat):
            return None
        vals.append(flat[0])
    vals[-1] = math.cos(0.5 * vals[-1])
    return tuple(vals)


def build_neighbor_cache(cfg: NeighborConfig, state: AgentState):
    """(perm, nbr, valid, overflow, count) over the population padded to
    a multiple of `block` (pad rows parked at agent 0's position), with
    the skin-extended cutoff. `count` [B] int32 is the valid entries per
    table row, which the CUDA kernels read in place of `valid`: counted
    here once per rebuild and not once per step."""
    n = state.n
    npad = -(-n // cfg.block) * cfg.block
    x, y = state.s[:, X], state.s[:, Y]
    if npad != n:
        x = torch.cat([x, x[:1].expand(npad - n)])
        y = torch.cat([y, y[:1].expand(npad - n)])
    perm, nbr, valid, overflow = NB.build(
        x, y, cfg.cutoff + cfg.skin, cfg.block, cfg.kb,
        block_src=cfg.block_src, table_chunk=cfg.table_chunk)
    return perm, nbr, valid, overflow, valid.sum(dim=1, dtype=torch.int32)


def sorted_packs(src_pack, perm):
    """Source and receiver packs in cell-sorted order: one row gather of
    the source pack; the receiver pack is its columns 0-3 plus the
    receiver activity flag (column 15), transposed."""
    src_sorted = src_pack[perm]
    recv_sorted = torch.zeros((PF.RECV_ROWS, src_pack.shape[0]),
                              dtype=src_pack.dtype, device=src_pack.device)
    recv_sorted[:4] = src_sorted[:, :4].T
    recv_sorted[4] = src_sorted[:, PF._RACT]
    return src_sorted, recv_sorted


def unsort_forces(out, perm, n):
    """Scatter the [2, npad] sorted force rows back to agent order."""
    sc = torch.empty_like(out)
    sc[:, perm] = out
    return sc[0, :n], sc[1, :n]


def pair_kernel_dispatch(cfg: NeighborConfig, nbr, valid, src_sorted,
                         recv_sorted, fov: bool = True, uniform=None,
                         priority_p2r: bool = False, mixed: bool = False,
                         count=None):
    """[2, B*block] sorted forces from cell-sorted packs through the
    kernel `cfg.backend` names: the CUDA kernel (float32) for CUDA
    tensors, its plain version in the packs' dtype for CPU tensors. The
    screens compare with `cfg.cutoff`, without the skin; K3 always reads
    the per-source field columns. `mixed` selects each source row's field
    family by its column 13 (the legacy field's form); it excludes
    `uniform`. `count` is the table's valid entries per row where the
    caller has them (`build_neighbor_cache`)."""
    dtype = src_sorted.dtype
    if src_sorted.is_cuda:
        src_sorted = src_sorted.float()
        recv_sorted = recv_sorted.float()
    kw = dict(block=cfg.block, fov=fov, priority_p2r=priority_p2r,
              mixed=mixed, count=count)
    if cfg.backend == "pallas_unrolled":
        out = PF.pair_forces_neighbors_unrolled(
            nbr, valid, src_sorted, recv_sorted, block_src=cfg.block_src,
            uniform=uniform, **kw)
    elif cfg.backend == "pallas_db":
        out = PF.pair_forces_neighbors_db(
            nbr, valid, src_sorted, recv_sorted, cutoff=cfg.cutoff, **kw)
    else:
        out = PF.pair_forces_neighbors(
            nbr, valid, src_sorted, recv_sorted, block_src=cfg.block_src,
            uniform=uniform, screen=cfg.screen, sub=cfg.sub,
            cutoff=cfg.cutoff, **kw)
    return out.to(dtype)


_PER_AGENT_FIELDS = (
    "s", "dyn_x", "dyn_v", "dyn_gains", "pid_e", "pid_i", "dest", "destqueue",
    "destpointer", "nq", "znav", "znavparams", "i_stopsignal",
    "d_stopsignal", "zrid", "walk_ok_steps", "uid",
)

_ALL_AGENT_FIELDS = _PER_AGENT_FIELDS + ("i", "pos_hist", "active")


def permute_state(state: AgentState, perm) -> AgentState:
    """Reorder the agent rows of every per-agent field by `perm` (one row
    gather per field)."""
    return state.replace(**{f: getattr(state, f)[perm]
                            for f in _ALL_AGENT_FIELDS})


def _freeze_inactive(act, old: AgentState, new: AgentState) -> AgentState:
    """Hold the complete pre-step state of inactive agents."""
    upd = {}
    for f in _PER_AGENT_FIELDS:
        o, u = getattr(old, f), getattr(new, f)
        mask = act.reshape((-1,) + (1,) * (u.ndim - 1))
        upd[f] = torch.where(mask, u, o)
    return new.replace(**upd)


def _check_state_widths(widths, state):
    """Reject a state built for another model (make_state(model=...)
    zero-sizes the fields a model never touches)."""
    for f, need in (widths or {}).items():
        a = getattr(state, f, None)
        if a is not None and a.ndim > 1 and a.shape[1] < need:
            raise ValueError(
                f"state.{f} has width {a.shape[1]} but this model needs "
                f">= {need}: the state was built for a different model")


_STATE_FIELDS = _ALL_AGENT_FIELDS + ("t_glob",)


def _map_state(fn, state: AgentState) -> AgentState:
    return state.replace(**{f: fn(getattr(state, f))
                            for f in _STATE_FIELDS})


def _copy_state(dst: AgentState, src: AgentState):
    """Copy every field of `src` into the tensors of `dst`, in place."""
    for f in _STATE_FIELDS:
        getattr(dst, f).copy_(getattr(src, f))


def _check_params_on(params, device):
    """A CUDA-graph capture takes no host-to-device copy: every per-agent
    parameter tensor must already lie on the state's device."""
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if isinstance(v, torch.Tensor) and v.device != device:
            raise ValueError(
                f"params.{f.name} is on {v.device} but the state is on "
                f"{device}: a graphed simulate copies nothing from the "
                f"host inside a step. Build per-agent parameters with "
                f"as_population(..., device={str(device)!r}), or run "
                f"simulate(graph=False)")


def record_buffers(mode, steps: int, state: AgentState) -> tuple:
    """The preallocated record tensors of `steps` steps in record mode
    `mode`: () for None, ([T, N, 8],) for "states", ([T, N, 8], [T, N],
    [T, N]) for "forces", ([T, 8],) for "metrics"."""
    def buf(*shape):
        return torch.empty((steps, *shape), dtype=state.s.dtype,
                           device=state.device)

    if mode == "states":
        return (buf(state.n, STATE_DIM),)
    if mode == "forces":
        return (buf(state.n, STATE_DIM), buf(state.n), buf(state.n))
    if mode == "metrics":
        return (buf(len(Engine.METRIC_NAMES)),)
    return ()


class ChunkRunner:
    """The `k` steps of one table-rebuild chunk of `Engine.simulate`
    behind static buffers: the port's counterpart of the JAX package's
    compiled inner `lax.scan`.

    A CUDA graph reads and writes fixed addresses. So the runner owns a
    static input state, static copies of the chunk's neighbor cache and
    of its overflow count, and static [k, ...] record rows. `run` copies
    the chunk's state and cache in, replays the graph (captured once, at
    construction, from `Engine.run_chunk` on those buffers) and hands
    back the graph's output state and the record rows. Both are
    overwritten by the next `run`: the caller copies out what it keeps.

    `_capture` and `_replay` are the only parts that need a card; the
    buffer logic around them is the same on any device.

    The capture bakes in what the engine's step reads from Python:
    shared parameters, the NeighborConfig, the kernel form. An engine
    keeps its runners until one of those attributes is assigned, and
    `Engine.with_params` starts a new engine without them.

    Launch counters: the warm-up chunk launches its `k` kernels through
    their wrappers, which count them. The capture runs the wrappers again,
    but records the launches instead of running them (`captured`, the
    recorded launches per kernel), and a replay runs them without a
    wrapper: the runner counts its `replays`, and `launches` is their
    product."""

    def __init__(self, engine, state: AgentState, cache, k: int,
                 presorted: bool, mode):
        # a weak reference: the engine owns its runners, and a cycle
        # would leave a dropped engine's graphs to the cyclic collector,
        # which may destroy them while another graph is being captured
        # (CUDA refuses that and drops the capture)
        self.engine, self.k = weakref.proxy(engine), k
        self.presorted, self.mode = presorted, mode
        self.state_in = _map_state(torch.empty_like, state)
        self.cache = tuple(torch.empty_like(c) for c in cache)
        self.overflow = torch.zeros((), dtype=state.s.dtype,
                                    device=state.device)
        self.rows = record_buffers(mode, k, state)
        self.graph = None
        self.state_out = None
        self.replays = 0
        self._load(state, cache)
        t0 = time.perf_counter()
        recorded = PF.captured_counts()
        self._capture()
        self.captured = tuple(a - b for a, b in
                              zip(PF.captured_counts(), recorded))
        self.capture_seconds = time.perf_counter() - t0   # with the warm-up

    def _load(self, state, cache):
        _copy_state(self.state_in, state)
        for dst, src in zip(self.cache, cache):
            dst.copy_(src)
        if self.mode == "metrics":
            self.overflow.copy_(cache[3].sum())

    def _body(self) -> AgentState:
        return self.engine.run_chunk(self.state_in, self.cache, self.k,
                                     self.presorted, self.mode, self.rows,
                                     self.overflow)

    def _capture(self):
        """Capture `_body` into `self.graph`; its result, which lives in
        the graph's memory, becomes `self.state_out`."""
        device = self.state_in.device
        _check_params_on(self.engine.params, device)
        with torch.cuda.device(device):
            # Warm-up on a side stream, as a capture needs: the kernel
            # library builds and loads, CUDA loads every kernel the chunk
            # launches, the launchers set their shared-memory attribute,
            # and the engine builds its constant pack columns, all of
            # which a capture would refuse or freeze into the graph's
            # pool. It reads the static input and writes only the static
            # rows and tensors of its own.
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.state_out = self._body()

    def _replay(self):
        self.graph.replay()

    def run(self, state: AgentState, cache):
        """One chunk from `state` on the table `cache`: (final state,
        record rows), both static tensors that the next `run`
        overwrites."""
        self._load(state, cache)
        self._replay()
        self.replays += 1
        return self.state_out, self.rows

    def launches(self) -> tuple:
        """Kernel launches made by this runner's replays, in
        `ops.pair_forces.KERNELS` order."""
        return tuple(self.replays * c for c in self.captured)


class Engine(nn.Module):
    """One shared space with one homogeneous-model agent population and a
    named repulsive field ("twod" or "legacy"), dense or culled. Build
    with `Engine.create`.

    Parameters shared by the population are Python floats, and the
    state's device decides where each step runs. The engine owns two
    caches of device tensors, both filled on demand and both private to
    it (`with_params` starts a new engine with neither): the constant
    columns of the pair packs, one set per parameter values, population
    size, dtype and device (`pack_pair_fields`), and the `ChunkRunner`s
    of `simulate` with their static buffers and CUDA graphs, one per
    captured program. A captured program froze what it read from the
    engine's attributes: assigning one of them (`params`, `neighbors`,
    ...) empties both caches, and the next `simulate` captures anew."""

    # what a captured chunk and the kept pack columns read from the engine
    _FROZEN_BY_A_CAPTURE = frozenset((
        "params", "model_step", "state_widths", "dest_force", "rep_force",
        "pair_family", "neighbors", "full_fov", "uniform_pair",
        "priority_p2r", "rep_chunk"))

    def __init__(self, params, model_step, state_widths, dest_force,
                 rep_force, pair_family: str, neighbors, full_fov: bool,
                 uniform_pair, priority_p2r: bool = False,
                 rep_chunk: int | None = None):
        super().__init__()
        self.params = params
        self.model_step = model_step
        self.state_widths = state_widths
        self.dest_force = dest_force
        self.rep_force = rep_force
        self.pair_family = pair_family
        self.neighbors = neighbors
        self.full_fov = full_fov
        self.uniform_pair = uniform_pair
        self.priority_p2r = priority_p2r
        self.rep_chunk = rep_chunk
        self._columns = {}    # (name, values, n, dtype, device) -> [n]
        self._runners = {}    # captured program -> ChunkRunner

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name in self._FROZEN_BY_A_CAPTURE and "_runners" in self.__dict__:
            self._columns.clear()
            self._runners.clear()

    @classmethod
    def create(cls, params, model, dest_force=None, rep_force=None,
               priority_rule: str = "unregulated",
               rep_chunk: int | None = None,
               neighbors: NeighborConfig | None = None, rep_reduce=None,
               combine_forces=None):
        """Build an engine from a model module (`models.MODELS`).

        dest_force, rep_force : registry names (`DEST_FORCES`,
            `REP_FORCES`); omitted, the model's `DEST_FORCE` /
            `REP_FORCE` apply (bicycle2d: "straight", "legacy").
        priority_rule : "p2r" (priority to the right) masks out every
            source to the receiver's left in the pair stage; any other
            value leaves the field unregulated, as in the JAX package.
        rep_chunk : receivers per chunk of the dense pair stage (None: all
            at once); it must divide N.
        neighbors : a NeighborConfig selects the culled pair stage; None
            the dense one.

        Custom force callables, `rep_reduce` and `combine_forces` are not
        ported and raise."""
        dest = dest_force if dest_force is not None else model.DEST_FORCE
        rep = rep_force if rep_force is not None else model.REP_FORCE
        if not isinstance(dest, str) or dest not in DEST_FORCES:
            raise NotImplementedError(
                f"destination force {dest!r} is not ported (have "
                f"{sorted(DEST_FORCES)})")
        if not isinstance(rep, str) or rep not in REP_FORCES:
            raise NotImplementedError(
                f"repulsive force {rep!r} is not ported (have "
                f"{sorted(REP_FORCES)})")
        if (rep_reduce is not None or combine_forces is not None
                or getattr(model, "REP_REDUCE", None) is not None
                or getattr(model, "COMBINE_FORCES", None) is not None):
            raise NotImplementedError(
                "rep_reduce and combine_forces hooks are not ported")
        return cls(params=params, model_step=model.step,
                   state_widths=getattr(model, "STATE_WIDTHS", None),
                   dest_force=DEST_FORCES[dest], rep_force=REP_FORCES[rep],
                   pair_family=rep, neighbors=neighbors,
                   full_fov=_hfov_is_full(params),
                   uniform_pair=(_uniform_pair_params(params)
                                 if rep == "twod" else None),
                   priority_p2r=(priority_rule == "p2r"),
                   rep_chunk=rep_chunk)

    def with_params(self, params):
        """Engine with `params` swapped in and the fields derived from
        them (`full_fov`, `uniform_pair`) recomputed: the kernels take
        both as compile-time forms, so stale values would apply the old
        constants or FOV elision to the new parameters."""
        return type(self)(
            params=params, model_step=self.model_step,
            state_widths=self.state_widths, dest_force=self.dest_force,
            rep_force=self.rep_force, pair_family=self.pair_family,
            neighbors=self.neighbors, full_fov=_hfov_is_full(params),
            uniform_pair=(_uniform_pair_params(params)
                          if self.pair_family == "twod" else None),
            priority_p2r=self.priority_p2r, rep_chunk=self.rep_chunk)

    # ---- the dense pair stage ----

    def repulsive_sum(self, state: AgentState):
        """Summed repulsive force (fx, fy) [N] on every agent from every
        other agent: the [N, N] (or, with `rep_chunk`, [N, rep_chunk]
        receiver-chunk) tiles of the field, masked by
        `ops.forces.untracked_foes_tile` and summed over the sources."""
        n = state.n
        s = state.s
        src = (s[:, X], s[:, Y], s[:, PSI], s[:, V])
        idx = torch.arange(n, device=s.device)
        hfov = _per_agent(self.params.hfov, n, s)

        def recv_tile(ri):
            recv = (s[ri, X], s[ri, Y], s[ri, PSI], s[ri, V])
            fpx, fpy = self.rep_force(self.params, src, recv)
            untracked = F.untracked_foes_tile(
                src[0], src[1], idx, state.active, hfov, recv[0], recv[1],
                recv[2], ri, state.active[ri],
                priority_p2r=self.priority_p2r)
            return F.sum_sources(fpx, fpy, ~untracked)

        c = self.rep_chunk
        if c is None or c >= n:
            return recv_tile(idx)
        if n % c != 0:
            raise ValueError(f"rep_chunk={c} must divide N={n}.")
        parts = [recv_tile(ri) for ri in idx.reshape(n // c, c)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    # ---- the culled pair stage ----

    def neighbor_cache(self, state: AgentState):
        return build_neighbor_cache(self.neighbors, state)

    def pack_pair_fields(self, state: AgentState, npad: int | None = None):
        """(src_pack [npad, 16], recv_pack [8, npad]) in the
        `ops.pair_forces` layout, padded to `npad` agents with inactive
        rows parked at agent 0's position (non-degenerate field
        parameters, zero amplitude: they emit nothing, and they take the
        twod branch of the mixed form).

        The legacy field packs every row as a legacy row of the mixed
        form: columns 4-7 are amp * emit (amp = p_0/p_decay), the
        excentricity e of the row's speed, 1/sqrt(1 - e^2) and 1/p_decay,
        column 13 (the family) is 1.

        A column that no step changes (a shared parameter, or a function
        of shared parameters only) is built once per value, population
        size, dtype and device and kept by the engine; the packs are
        stacked copies, so no caller holds a kept column."""
        n = state.n
        npad = n if npad is None else npad
        s = state.s
        dtype, dev = s.dtype, s.device
        values = {f: getattr(self.params, f)
                  for f in ("hfov", "p_0", "p_decay", "f_0", "e_0", "e_1",
                            "sigma_0", "sigma_1", "sigma_2", "sigma_3")
                  if hasattr(self.params, f)}
        if "p_0" in values:
            values["v_max"] = pair_hi(self.params.v_max_riding)

        def per_agent(v):
            return isinstance(v, torch.Tensor) and v.ndim >= 1

        def kept(name, build, *shared):
            key = (name, shared, n, dtype, dev)
            if key not in self._columns:
                self._columns[key] = build()
            return self._columns[key]

        def b(name):
            v = values[name]
            if per_agent(v):
                # per-agent table in original row order: index by uid so
                # a row's parameters follow it through permutations
                return v.to(device=dev, dtype=dtype)[state.uid.long()]
            return kept(name, lambda: torch.full((n,), float(v), dtype=dtype,
                                                 device=dev), float(v))

        def derived(name, fn, *fields):
            """fn of the columns `fields`, kept when all are shared."""
            def build():
                return fn(*map(b, fields))

            if any(per_agent(values[f]) for f in fields):
                return build()
            return kept(name, build, *(float(values[f]) for f in fields))

        x, y = s[:, X], s[:, Y]
        cpsi, spsi = torch.cos(s[:, PSI]), torch.sin(s[:, PSI])
        act = state.active.to(dtype)
        zero = kept("zero", lambda: torch.zeros((n,), dtype=dtype,
                                                device=dev))
        chf = derived("cos_half_hfov", lambda h: torch.cos(h / 2), "hfov")
        if self.pair_family == "legacy":
            e = F.legacy_excentricity(s[:, V], b("v_max"))
            amp = derived("amp", lambda p0, pd: p0 / pd, "p_0", "p_decay")
            inv_pd = derived("inv_p_decay", lambda pd: 1.0 / pd, "p_decay")
            one = kept("one", lambda: torch.ones((n,), dtype=dtype,
                                                 device=dev))
            emit = act * (amp > 0)
            src_cols = [x, y, cpsi, spsi, amp * emit, e,
                        1.0 / torch.sqrt(1.0 - e * e), inv_pd, zero,
                        zero, zero, chf, emit, one, zero, act]
        else:
            f0 = b("f_0")
            emit = act * (f0 > 0)
            src_cols = [x, y, cpsi, spsi, f0 * emit, b("e_0"), b("e_1"),
                        b("sigma_0"), b("sigma_1"), b("sigma_2"),
                        b("sigma_3"), chf, emit, zero, zero, act]
        src_pack = torch.stack(src_cols, dim=1)
        recv_pack = torch.stack([x, y, cpsi, spsi, act, zero, zero, zero],
                                dim=0)
        if npad != n:
            pad = npad - n
            src_pad = torch.zeros((pad, PF.SRC_COLS), dtype=dtype,
                                  device=dev)
            src_pad[:, 0] = x[0]
            src_pad[:, 1] = y[0]
            # row 0's field columns, zero amplitude, family 0
            src_pad[:, 5:11] = src_pack[0, 5:11]
            recv_pad = torch.zeros((PF.RECV_ROWS, pad), dtype=dtype,
                                   device=dev)
            recv_pad[0] = x[0]
            recv_pad[1] = y[0]
            src_pack = torch.cat([src_pack, src_pad], dim=0)
            recv_pack = torch.cat([recv_pack, recv_pad], dim=1)
        return src_pack, recv_pack

    def pair_kernel_dispatch(self, nbr, valid, src_sorted, recv_sorted,
                             count=None):
        """`pair_kernel_dispatch` in this engine's form: the legacy family
        through the mixed-family form (every row legacy), which takes no
        shared constants."""
        mixed = self.pair_family == "legacy"
        return pair_kernel_dispatch(self.neighbors, nbr, valid, src_sorted,
                                    recv_sorted, fov=not self.full_fov,
                                    uniform=None if mixed
                                    else self.uniform_pair,
                                    priority_p2r=self.priority_p2r,
                                    mixed=mixed, count=count)

    def repulsive_sum_neighbors(self, state: AgentState, cache=None,
                                presorted: bool = False):
        """Culled pairwise forces (fx, fy) [N]. `cache` is a prebuilt
        `neighbor_cache` (amortized rebuilds). With presorted=True the
        rows are already in the cache's cell-sorted order (the
        sorted-resident path of `simulate`; N a multiple of the block):
        the pack gather and the force scatter are skipped."""
        cfg = self.neighbors
        n = state.n
        npad = -(-n // cfg.block) * cfg.block
        src_pack, recv_pack = self.pack_pair_fields(state, npad)
        if cache is None:
            cache = self.neighbor_cache(state)
        perm, nbr, valid = cache[0], cache[1], cache[2]
        count = cache[4] if len(cache) > 4 else None
        if presorted:
            out = self.pair_kernel_dispatch(nbr, valid, src_pack, recv_pack,
                                            count)
            return out[0, :n], out[1, :n]
        src_sorted, recv_sorted = sorted_packs(src_pack, perm)
        out = self.pair_kernel_dispatch(nbr, valid, src_sorted, recv_sorted,
                                        count)
        return unsort_forces(out, perm, n)

    # ---- one simulation step ----

    def calc_forces(self, state: AgentState, nbr_cache=None,
                    presorted: bool = False):
        """Total social force per agent: (fx, fy, state), the state
        carrying the navigation-FSM updates of the destination force
        (reference intersection.py:747-864)."""
        fdx, fdy, state = self.dest_force(self.params, state)
        if state.n > 1:
            if self.neighbors is not None:
                frx, fry = self.repulsive_sum_neighbors(
                    state, nbr_cache, presorted=presorted)
            else:
                frx, fry = self.repulsive_sum(state)
            return (*F.clamp_add_dest(frx, fry, fdx, fdy), state)
        return fdx, fdy, state

    def finish_step(self, before: AgentState, new: AgentState):
        """Freeze inactive agents, advance the step counters and record
        the position ring slot of the new global step (out of place)."""
        merged = _freeze_inactive(before.active, before, new)
        i = merged.i + before.active.to(merged.i.dtype)
        t1 = merged.t_glob + 1
        slot = (t1 % merged.hist_len).long().reshape(1)
        pos_hist = merged.pos_hist.index_copy(1, slot, merged.s[:, None, :2])
        return merged.replace(i=i, t_glob=t1, pos_hist=pos_hist)

    # per-step population metrics: the columns of the [T, 8] tensor that
    # simulate(record_metrics=True) returns. nbr_overflow counts the
    # receiver blocks whose in-range source blocks exceeded the
    # NeighborConfig's kb at the last table rebuild (the farthest were
    # dropped): non-zero means the culled forces are TRUNCATED and kb must
    # be raised.
    METRIC_NAMES = ("n_active", "v_mean", "v_max", "roll_max", "f_mean",
                    "f_max", "arrived_frac", "nbr_overflow")

    @staticmethod
    def step_metrics(state: AgentState, fx, fy, nbr_overflow=0.0):
        """Aggregate population metrics of one step: [8] values in the
        state's dtype on its device, in `METRIC_NAMES` order. Means are
        over the active agents (over 1 when none is active); v_max is
        -inf and roll_max and f_max are 0 when none is. `nbr_overflow` is
        a number or a 0-d tensor. No value is read back to the host."""
        s = state.s
        act = state.active
        w = act.to(s.dtype)
        n_active = torch.sum(w)
        n = torch.clamp(n_active, min=1.0)
        v = s[:, V]
        fmag = torch.sqrt(fx * fx + fy * fy)
        roll = torch.abs(s[:, THETA])
        if isinstance(nbr_overflow, torch.Tensor):
            overflow = nbr_overflow.to(dtype=s.dtype, device=s.device)
        else:
            overflow = torch.full((), float(nbr_overflow), dtype=s.dtype,
                                  device=s.device)
        return torch.stack([
            n_active,
            torch.sum(v * w) / n,
            torch.max(torch.where(act, v, float("-inf"))),
            torch.max(torch.where(act, roll, 0.0)),
            torch.sum(fmag * w) / n,
            torch.max(torch.where(act, fmag, 0.0)),
            torch.sum(state.znav[:, 2].to(s.dtype) * w) / n,
            overflow,
        ])

    def step_with_forces(self, state: AgentState, nbr_cache=None,
                         presorted: bool = False):
        """One full step; returns (state, fx, fy) with the applied
        forces."""
        _check_state_widths(self.state_widths, state)
        before = state
        fx, fy, state = self.calc_forces(state, nbr_cache,
                                         presorted=presorted)
        new = self.model_step(self.params, state, fx, fy)
        return self.finish_step(before, new), fx, fy

    def step(self, state: AgentState) -> AgentState:
        return self.step_with_forces(state)[0]

    def forward(self, state: AgentState) -> AgentState:
        return self.step(state)

    # ---- step loop ----

    def _record(self, mode, rows, t: int, state, fx, fy, overflow):
        """Write step `t`'s record into the preallocated `rows`
        (`record_buffers`)."""
        if mode == "metrics":
            rows[0][t] = self.step_metrics(state, fx, fy, overflow)
        elif mode is not None:
            rows[0][t] = state.s
            if mode == "forces":
                rows[1][t] = fx
                rows[2][t] = fy

    def run_chunk(self, state: AgentState, cache, k: int,
                  presorted: bool = False, mode=None, rows=(),
                  overflow=0.0) -> AgentState:
        """The `k` steps of one rebuild chunk on the chunk's table
        `cache`, step j's record written to `rows[...][j]`: the program
        `ChunkRunner` captures. `overflow` is the table's overflow count
        for the metrics. Nothing here reads a value back to the host or
        has a shape that depends on the data."""
        for j in range(k):
            state, fx, fy = self.step_with_forces(state, cache, presorted)
            self._record(mode, rows, j, state, fx, fy, overflow)
        return state

    def _run_steps(self, state, steps: int, mode, rows, t0: int):
        """`steps` steps that each build their own table (or the dense
        stage), recorded from row `t0` on."""
        for j in range(steps):
            cache, overflow = None, 0.0
            if self.neighbors is not None:
                cache = self.neighbor_cache(state)
                overflow = cache[3].sum()
            state, fx, fy = self.step_with_forces(state, cache)
            self._record(mode, rows, t0 + j, state, fx, fy, overflow)
        return state

    def _chunk_runner(self, runner_cls, state, cache, k, presorted, mode):
        """This engine's `runner_cls` for the program that these
        arguments fix, built (and captured) at first use."""
        key = (presorted, mode, k, state.device,
               tuple((tuple(t.shape), t.dtype) for t in
                     (getattr(state, f) for f in _STATE_FIELDS)),
               tuple(tuple(c.shape) for c in cache))
        if key not in self._runners:
            self._runners[key] = runner_cls(self, state, cache, k,
                                            presorted, mode)
        return self._runners[key]

    def graph_launches(self) -> tuple:
        """Kernel launches made by the replays of this engine's captured
        chunks so far, in `ops.pair_forces.KERNELS` order. The wrappers'
        own counters do not see them: a replay runs no wrapper."""
        per_runner = [r.launches() for r in self._runners.values()]
        return tuple(map(sum, zip(*per_runner))) or (0,) * len(PF.KERNELS)

    def simulate(self, state: AgentState, n_steps: int,
                 record: bool = True, record_forces: bool = False,
                 record_metrics: bool = False, graph=None):
        """Run `n_steps` steps. Returns (final_state, records): the
        [T, N, 8] recorded states; with record_forces the tuple (states,
        fx, fy) of [T, N, 8], [T, N] and [T, N] (the applied forces);
        None with record=False. record_metrics=True wins over both:
        records is then the [T, 8] per-step metrics under
        `METRIC_NAMES`, its nbr_overflow column the overflow count of the
        table each step used (0 on the dense stage).

        With a NeighborConfig the sort and neighbor table are rebuilt every
        `rebuild_every` steps, at chunk boundaries; the steps left over
        (n_steps % rebuild_every) rebuild every step. With record=False
        and no record_forces (whatever record_metrics: the metrics do not
        depend on the row order) and with N a multiple of the block,
        agent rows live in cell-sorted order for each whole chunk (one
        permutation of the state per rebuild instead of a pack gather and
        force scatter per step) and the original order is restored at the
        end.

        graph : how a chunk's `rebuild_every` steps run. None (default):
            on CUDA tensors as one CUDA graph, captured at this engine's
            first call of the program and replayed per chunk
            (`ChunkRunner`; bit for bit the eager loop's result), on CPU
            tensors as the eager loop. False: the eager loop, always.
            True: the graph, or an error where there is none to capture
            (CPU tensors; the dense stage, rebuild_every <= 1 or fewer
            steps than a chunk, which always loop eagerly). Rebuilds,
            the final un-permutation and the leftover steps are never
            captured. The returned state and records are the caller's
            own tensors: a later call does not touch them."""
        if record_metrics:
            mode = "metrics"
        elif record:
            mode = "forces" if record_forces else "states"
        else:
            mode = None
        if not any(graph is g for g in (None, False, True)):
            raise ValueError(f"graph must be None, False or True, got "
                             f"{graph!r}")
        k = self.neighbors.rebuild_every if self.neighbors is not None else 1
        chunked = k > 1 and n_steps >= k
        on_card = state.device.type == "cuda"
        if graph is True and not on_card:
            raise ValueError(
                f"graph=True needs CUDA tensors: the state is on "
                f"{state.device} (graph=None picks by the device)")
        if graph is True and not chunked:
            raise ValueError(
                f"graph=True: only the chunks of a NeighborConfig "
                f"with rebuild_every > 1 are captured, and this run has "
                f"none (rebuild_every {k}, {n_steps} steps)")
        if graph is None:
            graph = on_card and chunked
        return self._simulate(state, n_steps, mode,
                              not record and not record_forces,
                              ChunkRunner if graph else None)

    def _simulate(self, state, n_steps, mode, sorted_resident, runner_cls):
        """`simulate` in record mode `mode` (`record_buffers`), on the
        sorted-resident path where `sorted_resident` allows it and N is a
        multiple of the block; the chunks through this engine's
        `runner_cls` (`ChunkRunner`), or with None as eager loops."""
        k = self.neighbors.rebuild_every if self.neighbors is not None else 1
        rows = record_buffers(mode, n_steps, state)
        if k <= 1 or n_steps < k:
            state = self._run_steps(state, n_steps, mode, rows, 0)
            return state, self._records(mode, rows)

        n_chunks, rem = divmod(n_steps, k)
        presorted = sorted_resident and state.n % self.neighbors.block == 0
        ident = torch.arange(state.n, device=state.device)
        for c in range(n_chunks):
            cache = self.neighbor_cache(state)
            if presorted:
                state = permute_state(state, cache[0])
                ident = ident[cache[0]]
            chunk_rows = tuple(r[c * k:(c + 1) * k] for r in rows)
            if runner_cls is not None:
                runner = self._chunk_runner(runner_cls, state, cache, k,
                                            presorted, mode)
                state, static_rows = runner.run(state, cache)
                for dst, src in zip(chunk_rows, static_rows):
                    dst.copy_(src)
            else:
                state = self.run_chunk(state, cache, k, presorted, mode,
                                       chunk_rows, cache[3].sum()
                                       if mode == "metrics" else 0.0)
        if runner_cls is not None:
            # the runner's output state is overwritten by its next run
            state = _map_state(torch.clone, state)
        if presorted:
            state = permute_state(state, torch.argsort(ident))
        state = self._run_steps(state, rem, mode, rows, n_chunks * k)
        return state, self._records(mode, rows)

    @staticmethod
    def _records(mode, rows):
        if mode is None:
            return None
        return tuple(rows) if mode == "forces" else rows[0]
