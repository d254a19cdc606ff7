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
from cyclistsocialforce_tpu_torch.params import pair_hi
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
                         priority_p2r: bool = False, mixed: bool = False):
    """[2, B*block] sorted forces from cell-sorted packs through the
    kernel `cfg.backend` names: the CUDA kernel (float32) for CUDA
    tensors, its plain version in the packs' dtype for CPU tensors. The
    screens compare with `cfg.cutoff`, without the skin; K3 always reads
    the per-source field columns. `mixed` selects each source row's field
    family by its column 13 (the legacy field's form); it excludes
    `uniform`."""
    dtype = src_sorted.dtype
    if src_sorted.is_cuda:
        src_sorted = src_sorted.float()
        recv_sorted = recv_sorted.float()
    kw = dict(block=cfg.block, fov=fov, priority_p2r=priority_p2r,
              mixed=mixed)
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
    """One shared space with one homogeneous-model agent population and a
    named repulsive field ("twod" or "legacy"), dense or culled. Build
    with `Engine.create`.

    The engine holds no tensors of its own: parameters shared by the
    population are Python floats, and the state's device decides where
    each step runs."""

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
        column 13 (the family) is 1."""
        n = state.n
        npad = n if npad is None else npad
        s = state.s
        dtype, dev = s.dtype, s.device

        def bb(v):
            if isinstance(v, torch.Tensor) and v.ndim >= 1:
                # per-agent table in original row order: index by uid so
                # a row's parameters follow it through permutations
                return v.to(device=dev, dtype=dtype)[state.uid.long()]
            return torch.full((n,), float(v), dtype=dtype, device=dev)

        def b(field):
            return bb(getattr(self.params, field))

        x, y = s[:, X], s[:, Y]
        cpsi, spsi = torch.cos(s[:, PSI]), torch.sin(s[:, PSI])
        act = state.active.to(dtype)
        zero = torch.zeros((n,), dtype=dtype, device=dev)
        chf = torch.cos(b("hfov") / 2)
        if self.pair_family == "legacy":
            e = F.legacy_excentricity(s[:, V],
                                      bb(pair_hi(self.params.v_max_riding)))
            p_decay = b("p_decay")
            amp = b("p_0") / p_decay
            emit = act * (amp > 0)
            src_cols = [x, y, cpsi, spsi, amp * emit, e,
                        1.0 / torch.sqrt(1.0 - e * e), 1.0 / p_decay, zero,
                        zero, zero, chf, emit, torch.ones_like(zero), zero,
                        act]
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

    def pair_kernel_dispatch(self, nbr, valid, src_sorted, recv_sorted):
        """`pair_kernel_dispatch` in this engine's form: the legacy family
        through the mixed-family form (every row legacy), which takes no
        shared constants."""
        mixed = self.pair_family == "legacy"
        return pair_kernel_dispatch(self.neighbors, nbr, valid, src_sorted,
                                    recv_sorted, fov=not self.full_fov,
                                    uniform=None if mixed
                                    else self.uniform_pair,
                                    priority_p2r=self.priority_p2r,
                                    mixed=mixed)

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
                 record: bool = True, record_forces: bool = False):
        """Run `n_steps` steps. Returns (final_state, traj): traj is the
        [T, N, 8] recorded states, with record_forces the tuple
        (states, fx, fy) of [T, N, 8], [T, N] and [T, N] (the applied
        forces), and None with record=False.

        With a NeighborConfig the sort and neighbor table are rebuilt every
        `rebuild_every` steps, at chunk boundaries; the steps left over
        (n_steps % rebuild_every) rebuild every step. Without recording
        and with N a multiple of the block, agent rows live in cell-sorted
        order for each whole chunk (one permutation of the state per
        rebuild instead of a pack gather and force scatter per step) and
        the original order is restored at the end."""
        recs = []

        def run(st, steps, cache=None, presorted=False):
            for _ in range(steps):
                c = cache
                if c is None and self.neighbors is not None:
                    c = self.neighbor_cache(st)
                st, fx, fy = self.step_with_forces(st, c, presorted)
                if record:
                    recs.append((st.s, fx, fy) if record_forces else st.s)
            return st

        def result(st):
            if not record:
                return st, None
            if record_forces:
                return st, tuple(torch.stack(r) for r in zip(*recs))
            return st, torch.stack(recs)

        k = self.neighbors.rebuild_every if self.neighbors is not None else 1
        if k <= 1 or n_steps < k:
            return result(run(state, n_steps))

        n_chunks, rem = divmod(n_steps, k)
        if not record and state.n % self.neighbors.block == 0:
            ident = torch.arange(state.n, device=state.device)
            for _ in range(n_chunks):
                cache = self.neighbor_cache(state)
                state = permute_state(state, cache[0])
                ident = ident[cache[0]]
                state = run(state, k, cache, presorted=True)
            state = permute_state(state, torch.argsort(ident))
        else:
            for _ in range(n_chunks):
                state = run(state, k, self.neighbor_cache(state))
        return result(run(state, rem))
