"""Heterogeneous-model populations: different dynamics in one space.

Counterpart of `cyclistsocialforce_tpu.mixed`. Agents are grouped by model
into contiguous row slices fixed at build time; each group's destination
force and dynamics run on its slice, and the pair stage evaluates each
source row's own force family (reference intersection.py:813-823: the
field's shape belongs to the emitting agent). Dense, one tile per group of
sources over all receivers; culled, the pair kernels' mixed-family form,
whose column 13 selects each source row's field (twod or legacy).

`MixedEngine` is an `engine.Engine`: it reuses the step loop, the chunk
runner (a CUDA graph per chunk on the card) and the culled pair stage, and
replaces the per-group parts. Its rows stay in their original order
(`sorted_resident` is False): group membership is a row range.
"""

from __future__ import annotations

from dataclasses import dataclass

import math

import torch
from torch import nn

from cyclistsocialforce_tpu_torch import engine as eng
from cyclistsocialforce_tpu_torch.ops import forces as F
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
from cyclistsocialforce_tpu_torch.ops import random as rnd
from cyclistsocialforce_tpu_torch.params import pair_hi
from cyclistsocialforce_tpu_torch.state import PSI, V, X, Y, AgentState

_SLICE_FIELDS = eng._ALL_AGENT_FIELDS


def state_slice(state: AgentState, lo: int, hi: int) -> AgentState:
    """Rows [lo, hi) of every per-agent field (views)."""
    return state.replace(**{f: getattr(state, f)[lo:hi]
                            for f in _SLICE_FIELDS})


def state_merge(state: AgentState, lo: int, hi: int,
                sub: AgentState) -> AgentState:
    """`state` with rows [lo, hi) of every per-agent field taken from
    `sub`, cast to the state's dtypes (out of place)."""
    def merged(f):
        a = getattr(state, f)
        return torch.cat([a[:lo], getattr(sub, f).to(a.dtype), a[hi:]])

    return state.replace(**{f: merged(f) for f in _SLICE_FIELDS})


def _merge_groups(state: AgentState, subs) -> AgentState:
    """`state` with every per-agent field the groups' slices `subs` end to
    end: one concatenation per field for all groups (the groups are
    disjoint and cover the rows in order)."""
    return state.replace(**{
        f: torch.cat([getattr(sub, f).to(getattr(state, f).dtype)
                      for sub in subs])
        for f in _SLICE_FIELDS})


@dataclass(frozen=True)
class ModelGroup:
    """One contiguous slice [lo, hi) of agents sharing a model and its
    parameters."""

    params: object
    model: object          # the model module (`models.MODELS`)
    dest_force: object
    dest_kw: dict
    rep_name: str
    lo: int
    hi: int

    @property
    def size(self) -> int:
        return self.hi - self.lo


class MixedEngine(eng.Engine):
    """Interaction engine over a partitioned heterogeneous population.
    Build with `create(group_specs)`; agent rows [lo, hi) of the state
    belong to the groups in order. With a `NeighborConfig` the pair stage
    runs culled through the pair kernels' mixed-family form (per-row
    columns, the config's screen), else dense."""

    sorted_resident = False
    # the named families only: the pair channels are summed and clamped
    rep_reduce = None
    combine_forces = None
    # no group's model takes the per-agent kernels (`Engine.agent_kernels`)
    kernel_hook = None
    _FROZEN_BY_A_CAPTURE = frozenset((
        "groups", "neighbors", "full_fov", "priority_p2r", "road",
        "scripted"))

    def __init__(self, groups, neighbors=None, priority_p2r: bool = False,
                 full_fov: bool = False, road=None, scripted=None):
        nn.Module.__init__(self)
        self.groups = tuple(groups)
        self.neighbors = neighbors
        self.priority_p2r = priority_p2r
        self.full_fov = full_fov
        self.road = road
        self.scripted = scripted
        self.pair_family = "mixed"
        self.uniform_pair = None
        self._columns = {}
        self._runners = {}

    @classmethod
    def create(cls, group_specs, road=None,
               priority_rule: str = "unregulated", scripted=None,
               neighbors=None):
        """group_specs : (model module or `models.MODELS` name, params,
            n_agents) per group, in row order. Each group takes its model's
            `DEST_FORCE` (a registry name or a callable) and `REP_FORCE` (a
            registry name).
        priority_rule, neighbors, road, scripted : as for
            `Engine.create` (the scripts indexed by uid over all groups'
            rows)."""
        from cyclistsocialforce_tpu_torch.models import MODELS

        if scripted is not None and not isinstance(scripted,
                                                   eng.ScriptedTraj):
            raise TypeError(f"scripted must be a ScriptedTraj, got "
                            f"{type(scripted).__name__}")
        if neighbors is not None and neighbors.backend == eng.GENERIC_BACKEND:
            raise ValueError(
                f"backend {eng.GENERIC_BACKEND!r} is the generic path of "
                f"custom force tiles; MixedEngine's fields go through one "
                f"of {eng.KERNEL_BACKENDS}{eng.PLAIN_VERSION_HINT}")
        groups, lo = [], 0
        for model, params, n in group_specs:
            if isinstance(model, str):
                model = MODELS[model]
            dest, rep = model.DEST_FORCE, model.REP_FORCE
            if not isinstance(rep, str) or rep not in eng.REP_FORCES:
                raise ValueError(
                    f"MixedEngine supports the named force families "
                    f"{sorted(eng.REP_FORCES)}; custom tiles need a "
                    f"dedicated Engine")
            fn = (eng._registered(eng.DEST_FORCES, dest, "destination force")
                  if isinstance(dest, str) else dest)
            groups.append(ModelGroup(
                params=params, model=model, dest_force=fn,
                dest_kw=eng.dest_force_kw(fn, params), rep_name=rep, lo=lo,
                hi=lo + int(n)))
            lo += int(n)
        return cls(groups, neighbors=neighbors,
                   priority_p2r=(priority_rule == "p2r"),
                   full_fov=all(eng._hfov_is_full(g.params)
                                for g in groups), road=road,
                   scripted=scripted)

    @property
    def n(self) -> int:
        return self.groups[-1].hi

    def step(self, state: AgentState, nbr_cache=None) -> AgentState:
        """One step; `nbr_cache` a prebuilt `neighbor_cache` (None: the
        culled stage builds its own)."""
        return self.step_with_forces(state, nbr_cache)[0]

    # ---- per-group parts of the step ----

    def check_state(self, state: AgentState):
        """A mixed population needs the union of every group's fields,
        and exactly the groups' rows."""
        if state.n != self.n:
            raise ValueError(f"the state has {state.n} rows, the groups "
                             f"{self.n}")
        for g in self.groups:
            eng._check_state_widths(getattr(g.model, "STATE_WIDTHS", None),
                                    state)

    def check_params_on(self, device):
        for g in self.groups:
            eng._check_params_on(g.params, device)

    def destination_forces(self, state: AgentState):
        """Each group's destination force on its slice."""
        fx, fy, subs = [], [], []
        for g in self.groups:
            gfx, gfy, sub = g.dest_force(
                g.params, state_slice(state, g.lo, g.hi), **g.dest_kw)
            fx.append(gfx.to(state.s.dtype))
            fy.append(gfy.to(state.s.dtype))
            subs.append(sub)
        return torch.cat(fx), torch.cat(fy), _merge_groups(state, subs)

    def clock_period(self) -> int:
        """The least common multiple of the groups' `clock_period`s."""
        return math.lcm(*(getattr(g.model, "clock_period",
                                  lambda p: 1)(g.params)
                          for g in self.groups))

    def dynamics(self, state: AgentState, fx, fy,
                 t_host=None) -> AgentState:
        """Each group's model step on its slice. A group that draws random
        numbers reads the master key folded with its index, as the JAX
        package's MixedEngine gives it (its draws stay a function of the
        key, the group, t_glob and the uid)."""
        subs = []
        for i, g in enumerate(self.groups):
            sub = state_slice(state, g.lo, g.hi)
            if (getattr(g.params, "stochastic_control_behavior", False)
                    or getattr(g.params, "br_disturb", False)):
                sub = sub.replace(key=rnd.fold_in(state.key, i))
            subs.append(g.model.step(
                g.params, sub, fx[g.lo:g.hi], fy[g.lo:g.hi],
                **self.kept_constants(
                    getattr(g.model, "step_constants", None), g.params,
                    state, i),
                **self._clock_kw(getattr(g.model, "clock_period", None),
                                 g.params, t_host)))
        return _merge_groups(state, subs)

    # ---- the dense pair stage ----

    def repulsive_sum(self, state: AgentState):
        """Pair stage over all pairs: each group's sources through its
        family's tile at every receiver, masked by
        `ops.forces.untracked_foes_tile` and summed over the sources."""
        s = state.s
        n = state.n
        src = (s[:, X], s[:, Y], s[:, PSI], s[:, V])
        tiles = [eng.REP_FORCES[g.rep_name](
                     g.params, tuple(a[g.lo:g.hi] for a in src), src)
                 for g in self.groups]
        fx_pair = torch.cat([t[0].to(s.dtype) for t in tiles])
        fy_pair = torch.cat([t[1].to(s.dtype) for t in tiles])
        hfov = torch.cat([eng._per_agent(g.params.hfov, g.size, s)
                          for g in self.groups])
        idx = torch.arange(n, device=s.device)
        untracked = F.untracked_foes_tile(
            src[0], src[1], idx, state.active, hfov, src[0], src[1], src[2],
            idx, state.active, priority_p2r=self.priority_p2r)
        return F.sum_sources(fx_pair, fy_pair, ~untracked)

    # ---- the culled pair stage (Engine.repulsive_sum_neighbors) ----

    def group_masks(self, state: AgentState):
        """[n_rows] bool per group: its rows, by the persistent uid (the
        groups are contiguous in original row order), so the masks follow
        the agents through any permutation of the rows."""
        uid = state.uid
        return [(uid >= g.lo) & (uid < g.hi) for g in self.groups]

    def pack_pair_fields(self, state: AgentState, npad: int | None = None):
        """(src_pack [npad, 16], recv_pack [8, npad]) in the mixed layout
        of `ops.pair_forces`: column 13 is each row's family (0 twod, 1
        legacy); a legacy row holds (amp, e, 1/sqrt(1 - e^2), 1/p_decay) in
        columns 4-7 and zeros in 8-10. Each row takes its group's field
        parameters by uid. A parameter is per agent where it is a tensor
        (as `as_population` makes it; row r of the group is uid - lo) and
        shared where it is a number: the leaf's type decides, not its
        shape. Pad rows sit at row 0's position, emit nothing and take the
        twod branch with sigma_0 = 1."""
        n = state.n
        npad = n if npad is None else npad
        s = state.s
        dtype, dev = s.dtype, s.device
        masks = self.group_masks(state)
        uid = state.uid.long()

        def gval(value, g):
            if isinstance(value, torch.Tensor):
                off = torch.clamp(uid - g.lo, 0, g.size - 1)
                return value.to(dtype=dtype, device=dev)[off]
            return torch.full((n,), float(value), dtype=dtype, device=dev)

        def sel(per_group, default):
            out = torch.full((n,), default, dtype=dtype, device=dev)
            for m, v in zip(masks, per_group):
                out = torch.where(m, v, out)
            return out

        x, y = s[:, X], s[:, Y]
        cpsi, spsi = torch.cos(s[:, PSI]), torch.sin(s[:, PSI])
        act = state.active.to(dtype)
        zero = torch.zeros((n,), dtype=dtype, device=dev)
        cols = [[] for _ in range(7)]          # columns 4-10
        fam, chf = [], []
        for g in self.groups:
            p = g.params
            chf.append(torch.cos(gval(p.hfov, g) / 2))
            if g.rep_name == "twod":
                vals = [gval(getattr(p, f), g) for f in (
                    "f_0", "e_0", "e_1", "sigma_0", "sigma_1", "sigma_2",
                    "sigma_3")]
                fam.append(zero)
            else:                                    # legacy elliptic field
                e = F.legacy_excentricity(s[:, V],
                                          gval(pair_hi(p.v_max_riding), g))
                p_decay = gval(p.p_decay, g)
                vals = [gval(p.p_0, g) / p_decay, e,
                        1.0 / torch.sqrt(1.0 - e * e), 1.0 / p_decay,
                        zero, zero, zero]
                fam.append(torch.ones((n,), dtype=dtype, device=dev))
            for c, v in zip(cols, vals):
                c.append(v)

        c4 = sel(cols[0], 0.0)
        emit = act * (c4 > 0)
        # the amplitude carries the emit flag (as Engine.pack_pair_fields);
        # rows outside every group (none in practice) keep the field finite
        src_cols = [x, y, cpsi, spsi, c4 * emit, sel(cols[1], 0.0),
                    sel(cols[2], 1.0), sel(cols[3], 1.0), sel(cols[4], 0.0),
                    sel(cols[5], 0.0), sel(cols[6], 0.0), sel(chf, 1.0),
                    emit, sel(fam, 0.0), zero, act]
        src_pack = torch.stack(src_cols, dim=1)
        recv_pack = torch.stack([x, y, cpsi, spsi, act, zero, zero, zero],
                                dim=0)
        if npad != n:
            pad = npad - n
            src_pad = torch.zeros((pad, PF.SRC_COLS), dtype=dtype,
                                  device=dev)
            src_pad[:, 0] = x[0]
            src_pad[:, 1] = y[0]
            src_pad[:, 7] = 1.0
            recv_pad = torch.zeros((PF.RECV_ROWS, pad), dtype=dtype,
                                   device=dev)
            recv_pad[0] = x[0]
            recv_pad[1] = y[0]
            src_pack = torch.cat([src_pack, src_pad], dim=0)
            recv_pack = torch.cat([recv_pack, recv_pad], dim=1)
        return src_pack, recv_pack

    def pair_kernel_dispatch(self, nbr, valid, src_sorted, recv_sorted,
                             count=None):
        """`engine.pair_kernel_dispatch` in the mixed-family form, which
        reads the field columns (no shared constants)."""
        return eng.pair_kernel_dispatch(
            self.neighbors, nbr, valid, src_sorted, recv_sorted,
            fov=not self.full_fov, uniform=None,
            priority_p2r=self.priority_p2r, mixed=True, count=count,
            field_pairs=self.field_pairs(src_sorted.device))


def prepare_groups(engine: MixedEngine, state: AgentState) -> AgentState:
    """Each group's model `prepare` (`models.prepare`) on its slice."""
    from cyclistsocialforce_tpu_torch.models import prepare

    for g in engine.groups:
        sub = state_slice(state, g.lo, g.hi)
        state = state_merge(state, g.lo, g.hi, prepare(g.model, g.params,
                                                       sub))
    return state


__all__ = ["MixedEngine", "ModelGroup", "prepare_groups", "state_merge",
           "state_slice"]
