"""The social-force interaction engine of the PyTorch port.

Counterpart of `cyclistsocialforce_tpu.engine` for the culled "twod" main
path: one agent population on a shared space, advanced step by step --

  1. destination force with the destination-queue and navigation-FSM
     updates (`dest_force_straight`),
  2. pairwise repulsive forces over the block-sparse neighbor table
     (`repulsive_sum_neighbors`, the pair kernel of `ops.pair_forces`),
  3. repulsive-force magnitude clamp and summation (`ops.forces`),
  4. one dynamics step of every agent (the model's `step`),
  5. bookkeeping: inactive agents frozen, step counters, position ring.

Every stage is a batched function over the [N] agent axis. The pair stage
runs its CUDA kernel on CUDA tensors and its plain version on CPU
tensors: the state's device selects the backend.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from cyclistsocialforce_tpu_torch.ops import forces as F
from cyclistsocialforce_tpu_torch.ops import navigation as nav
from cyclistsocialforce_tpu_torch.ops import neighbors as NB
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
from cyclistsocialforce_tpu_torch.state import PSI, V, X, Y, AgentState


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


DEST_FORCES = {"straight": dest_force_straight,
               "direct": dest_force_straight}


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
        force near 1e-4.
    block : receivers per block (the CUDA kernel takes 128).
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
    """(perm, nbr, valid, overflow) over the population padded to a
    multiple of `block` (pad rows parked at agent 0's position), with the
    skin-extended cutoff."""
    n = state.n
    npad = -(-n // cfg.block) * cfg.block
    x, y = state.s[:, X], state.s[:, Y]
    if npad != n:
        x = torch.cat([x, x[:1].expand(npad - n)])
        y = torch.cat([y, y[:1].expand(npad - n)])
    return NB.build(x, y, cfg.cutoff + cfg.skin, cfg.block, cfg.kb,
                    block_src=cfg.block_src)


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
                         priority_p2r: bool = False):
    """[2, B*block] sorted forces from cell-sorted packs through the
    kernel `cfg.backend` names: the CUDA kernel (float32) for CUDA
    tensors, its plain version in the packs' dtype for CPU tensors. The
    screens compare with `cfg.cutoff`, without the skin; K3 always reads
    the per-source field columns."""
    dtype = src_sorted.dtype
    if src_sorted.is_cuda:
        src_sorted = src_sorted.float()
        recv_sorted = recv_sorted.float()
    kw = dict(block=cfg.block, fov=fov, priority_p2r=priority_p2r)
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


class Engine(nn.Module):
    """One shared space with one homogeneous-model agent population,
    culled "twod" pair field. Build with `Engine.create`.

    The engine holds no tensors of its own: parameters shared by the
    population are Python floats, and the state's device decides where
    each step runs."""

    def __init__(self, params, model_step, state_widths, dest_force,
                 neighbors: NeighborConfig, full_fov: bool, uniform_pair,
                 priority_p2r: bool = False):
        super().__init__()
        self.params = params
        self.model_step = model_step
        self.state_widths = state_widths
        self.dest_force = dest_force
        self.neighbors = neighbors
        self.full_fov = full_fov
        self.uniform_pair = uniform_pair
        self.priority_p2r = priority_p2r

    @classmethod
    def create(cls, params, model, dest_force=None, rep_force=None,
               priority_rule: str = "unregulated",
               neighbors: NeighborConfig | None = None):
        """Build an engine from a model module (`models.MODELS`).

        priority_rule "p2r" (priority to the right) masks out every
        source to the receiver's left in the pair stage; any other value
        leaves the field unregulated, as in the JAX package.

        Only the culled "twod" repulsive field with the straight-line
        destination force is ported: other force names, custom force
        callables and the dense (neighbors=None) pair stage raise."""
        dest = dest_force if dest_force is not None else model.DEST_FORCE
        rep = rep_force if rep_force is not None else model.REP_FORCE
        if dest not in DEST_FORCES:
            raise NotImplementedError(
                f"destination force {dest!r} is not ported (have "
                f"{sorted(DEST_FORCES)})")
        if rep != "twod":
            raise NotImplementedError(
                f"repulsive force {rep!r} is not ported: pass "
                f"rep_force='twod'")
        if neighbors is None:
            raise NotImplementedError(
                "the dense pair stage is not ported: pass a NeighborConfig")
        return cls(params=params, model_step=model.step,
                   state_widths=getattr(model, "STATE_WIDTHS", None),
                   dest_force=DEST_FORCES[dest], neighbors=neighbors,
                   full_fov=_hfov_is_full(params),
                   uniform_pair=_uniform_pair_params(params),
                   priority_p2r=(priority_rule == "p2r"))

    def with_params(self, params):
        """Engine with `params` swapped in and the fields derived from
        them (`full_fov`, `uniform_pair`) recomputed: the kernels take
        both as compile-time forms, so stale values would apply the old
        constants or FOV elision to the new parameters."""
        return type(self)(
            params=params, model_step=self.model_step,
            state_widths=self.state_widths, dest_force=self.dest_force,
            neighbors=self.neighbors, full_fov=_hfov_is_full(params),
            uniform_pair=_uniform_pair_params(params),
            priority_p2r=self.priority_p2r)

    # ---- one simulation step ----

    def neighbor_cache(self, state: AgentState):
        return build_neighbor_cache(self.neighbors, state)

    def pack_pair_fields(self, state: AgentState, npad: int | None = None):
        """(src_pack [npad, 16], recv_pack [8, npad]) in the
        `ops.pair_forces` layout, padded to `npad` agents with inactive
        rows parked at agent 0's position (non-degenerate field
        parameters, f_0 = 0: they emit nothing)."""
        n = state.n
        npad = n if npad is None else npad
        s = state.s
        dtype, dev = s.dtype, s.device

        def b(field):
            v = getattr(self.params, field)
            if isinstance(v, torch.Tensor) and v.ndim >= 1:
                # per-agent table in original row order: index by uid so
                # a row's parameters follow it through permutations
                return v.to(device=dev, dtype=dtype)[state.uid.long()]
            return torch.full((n,), float(v), dtype=dtype, device=dev)

        x, y = s[:, X], s[:, Y]
        cpsi, spsi = torch.cos(s[:, PSI]), torch.sin(s[:, PSI])
        act = state.active.to(dtype)
        f0 = b("f_0")
        emit = act * (f0 > 0)
        zero = torch.zeros((n,), dtype=dtype, device=dev)
        src_cols = [x, y, cpsi, spsi, f0 * emit, b("e_0"), b("e_1"),
                    b("sigma_0"), b("sigma_1"), b("sigma_2"), b("sigma_3"),
                    torch.cos(b("hfov") / 2), emit, zero, zero, act]
        src_pack = torch.stack(src_cols, dim=1)
        recv_pack = torch.stack([x, y, cpsi, spsi, act, zero, zero, zero],
                                dim=0)
        if npad != n:
            pad = npad - n
            src_pad = torch.zeros((pad, PF.SRC_COLS), dtype=dtype,
                                  device=dev)
            src_pad[:, 0] = x[0]
            src_pad[:, 1] = y[0]
            src_pad[:, 5:11] = src_pack[0, 5:11]
            recv_pad = torch.zeros((PF.RECV_ROWS, pad), dtype=dtype,
                                   device=dev)
            recv_pad[0] = x[0]
            recv_pad[1] = y[0]
            src_pack = torch.cat([src_pack, src_pad], dim=0)
            recv_pack = torch.cat([recv_pack, recv_pad], dim=1)
        return src_pack, recv_pack

    def pair_kernel_dispatch(self, nbr, valid, src_sorted, recv_sorted):
        return pair_kernel_dispatch(self.neighbors, nbr, valid, src_sorted,
                                    recv_sorted, fov=not self.full_fov,
                                    uniform=self.uniform_pair,
                                    priority_p2r=self.priority_p2r)

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
        if presorted:
            out = self.pair_kernel_dispatch(cache[1], cache[2], src_pack,
                                            recv_pack)
            return out[0, :n], out[1, :n]
        if cache is None:
            cache = self.neighbor_cache(state)
        perm, nbr, valid = cache[0], cache[1], cache[2]
        src_sorted, recv_sorted = sorted_packs(src_pack, perm)
        out = self.pair_kernel_dispatch(nbr, valid, src_sorted, recv_sorted)
        return unsort_forces(out, perm, n)

    def calc_forces(self, state: AgentState, nbr_cache=None,
                    presorted: bool = False):
        """Total social force per agent: (fx, fy, state), the state
        carrying the navigation-FSM updates of the destination force
        (reference intersection.py:747-864)."""
        fdx, fdy, state = self.dest_force(self.params, state)
        if state.n > 1:
            frx, fry = self.repulsive_sum_neighbors(state, nbr_cache,
                                                    presorted=presorted)
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

    def simulate(self, state: AgentState, n_steps: int,
                 record: bool = True):
        """Run `n_steps` steps. Returns (final_state, traj), traj the
        [T, N, 8] recorded states, or None with record=False.

        The sort and neighbor table are rebuilt every `rebuild_every`
        steps, at chunk boundaries; the steps left over
        (n_steps % rebuild_every) rebuild every step. Without recording
        and with N a multiple of the block, agent rows live in cell-sorted
        order for each whole chunk (one permutation of the state per
        rebuild instead of a pack gather and force scatter per step) and
        the original order is restored at the end."""
        recs = []

        def per_step_rebuild(st, steps):
            for _ in range(steps):
                st = self.step_with_forces(st, self.neighbor_cache(st))[0]
                if record:
                    recs.append(st.s)
            return st

        k = self.neighbors.rebuild_every
        if k <= 1 or n_steps < k:
            state = per_step_rebuild(state, n_steps)
            return state, (torch.stack(recs) if record else None)

        n_chunks, rem = divmod(n_steps, k)
        if not record and state.n % self.neighbors.block == 0:
            ident = torch.arange(state.n, device=state.device)
            for _ in range(n_chunks):
                cache = self.neighbor_cache(state)
                state = permute_state(state, cache[0])
                ident = ident[cache[0]]
                for _ in range(k):
                    state = self.step_with_forces(state, cache,
                                                  presorted=True)[0]
            state = permute_state(state, torch.argsort(ident))
        else:
            for _ in range(n_chunks):
                cache = self.neighbor_cache(state)
                for _ in range(k):
                    state = self.step_with_forces(state, cache)[0]
                    if record:
                        recs.append(state.s)
        state = per_step_rebuild(state, rem)
        return state, (torch.stack(recs) if record else None)

