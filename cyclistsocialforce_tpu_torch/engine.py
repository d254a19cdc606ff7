"""The social-force interaction engine of the PyTorch port.

Counterpart of `cyclistsocialforce_tpu.engine`: one agent population on a
shared space, advanced step by step --

  1. destination force with the destination-queue and navigation-FSM
     updates (`dest_force_straight`, `dest_force_hm`, `dest_force_spline`
     or an external model's callable), none for scripted agents,
  2. pairwise repulsive forces of the "twod" or "legacy" field or of a
     custom tile: dense over all pairs (`Engine.repulsive_sum`, plain
     PyTorch, as the JAX package computes it outside any Pallas kernel),
     or culled over the block-sparse neighbor table
     (`repulsive_sum_neighbors`: the pair kernels of `ops.pair_forces`
     for the named fields, the legacy field in their mixed-family form
     with every row legacy; a custom tile per receiver block through
     `repulsive_sum_neighbors_generic`, which has no kernel in either
     package),
  3. the repulsion reduced over the sources and combined with the
     destination force (the magnitude clamp of `ops.forces`, or an
     external model's `rep_reduce` and `combine_forces` hooks), plus the
     road-edge repulsion of a `RoadElements` (`ops.forces.road_edge_force`),
  4. one dynamics step of every agent (the model's `step`),
  5. bookkeeping: inactive agents frozen, scripted agents replayed
     (`ScriptedTraj`), step counters, position ring.

Every stage is a batched function over the [N] agent axis. The culled
pair stage runs its CUDA kernel on CUDA tensors and its plain version on
CPU tensors: the state's device selects the backend. Where the model
declares per-agent kernels (its `agent_kernels` hook) and the engine takes
them for a CUDA state (`Engine.agent_kernels`), stages 1 and 3-5 run as
two kernels around the pair kernel (`ops.agent_step`).

`Engine.simulate` is the step loop. The JAX package compiles a chunk of
`rebuild_every` steps (its inner `lax.scan`) into one program; the port's
counterpart is `ChunkRunner`, which captures the chunk's steps once as a
CUDA graph over static buffers and replays it per chunk.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
import weakref
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from cyclistsocialforce_tpu_torch import tracing
from cyclistsocialforce_tpu_torch.ops import agent_step as AS
from cyclistsocialforce_tpu_torch.ops import forces as F
from cyclistsocialforce_tpu_torch.ops import navigation as nav
from cyclistsocialforce_tpu_torch.ops import neighbors as NB
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
from cyclistsocialforce_tpu_torch.ops import spline as spl
from cyclistsocialforce_tpu_torch.ops.spline import (SPL_N_PNTS,
                                                     SPL_THETA_COMF,
                                                     SPL_V_MIN_STABLE)
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


# ---- the spline (path-planning) destination force ----

# local constants of the reference implementation (vehicle.py:1443-1448;
# SPL_N_PNTS, SPL_THETA_COMF and SPL_V_MIN_STABLE are ops/spline.py's)
SPL_N_FWD = 4          # most forward destinations in the spline
SPL_IPRED = 3          # look-ahead for normal riding
SPL_IPRED_LAST = 5     # look-ahead for the final destination


def spline_lookback(params):
    """The last-destination spline's 1 s lookback in steps, floor(1 /
    t_s) (reference vehicle.py:1486), when every agent shares t_s; None
    when t_s differs between agents (`dest_force_spline` then looks back
    per agent). Reads per-agent t_s on the host: an engine calls it once,
    when it is built, never inside a step."""
    ts = _values(params, "t_s")
    if all(t == ts[0] for t in ts):
        return int(math.floor(1.0 / ts[0]))
    return None


def _ring_row(pos_hist, step):
    """Every agent's [N, 2] ring entry of global step `step` (a 0-d device
    tensor): one index_select at slot step % H, no host read."""
    slot = torch.remainder(step, pos_hist.shape[1]).long().reshape(1)
    return pos_hist.index_select(1, slot)[:, 0]


def dest_force_spline(params, state: AgentState, lookback="auto"):
    """Spline path-planning destination force of the BMD2023 2D model
    (reference TwoDBicycle.calcDestinationForce, vehicle.py:1416-1558;
    the JAX package's `engine.dest_force_spline`): a parametric cubic
    through recent positions and upcoming queue destinations, the force
    along the spline's look-ahead, the desired speed limited by the
    spline's curvature radius R through a ~10 deg comfort lean, v =
    sqrt(theta_comf g R).

    Branches, branchless: step 0 pushes along the heading; "arrived" pushes
    nothing; a next destination that is not the last fits the previous and
    current positions and up to 4 forward destinations; the last
    destination fits the positions 1 s back, one step back and now, and
    the destination; a look-ahead past the spline's end, or a non-finite
    spline force (duplicate support points), falls back to the straight
    line after a second pass of the destination-queue update and the
    navigation FSM (the reference's quirk, vehicle.py:1556). The JAX
    package runs that second pass under `lax.cond` when any active agent
    needs it; here it runs every step and `torch.where` keeps its rows
    (the same rows, so the same results), because the step must read
    nothing back to the host.

    lookback : the 1 s lookback in steps, `spline_lookback(params)`, which
        an engine decides once when it is built (None: per agent, from
        each agent's t_s, by a one-hot contraction over the ring); "auto"
        decides it here (a host read of per-agent t_s)."""
    if isinstance(lookback, str):
        lookback = spline_lookback(params)
    n = state.n
    s = state.s
    dtype, dev = s.dtype, s.device
    npar = nav_params_view(params, s)
    g = _per_agent(params.g, n, s)
    hist = state.hist_len
    if lookback is not None and hist < lookback + 1:
        warnings.warn(
            f"spline destination force: pos_hist ring buffer "
            f"(hist_len={hist}) is shorter than the 1 s lookback "
            f"({lookback + 1} samples); the last-destination spline will "
            f"read wrapped (stale) samples -- build the state with "
            f"make_state(hist_len>={lookback + 1})", stacklevel=2)

    # ring lookbacks at the global step clock (slot t % H holds every
    # agent's position at global step t)
    tg = state.t_glob
    ph = state.pos_hist
    prev = _ring_row(ph, tg - 1)
    if lookback is not None:
        back = _ring_row(ph, tg - torch.clamp(tg, max=lookback))
    else:
        t_s = _per_agent(params.t_s, n, s)
        lb = torch.floor(1.0 / t_s).to(torch.int32)       # vehicle.py:1486
        jb = torch.remainder(tg - torch.minimum(tg, lb), hist)
        oh = torch.arange(hist, device=dev)[None, :] == jb[:, None]
        back = torch.sum(torch.where(oh[:, :, None], ph, 0.0), dim=1)

    pos = s[:, :2]
    v = s[:, V]
    i = state.i
    dq, nq = state.destqueue, state.nq

    # first pass: destination-queue update and navigation FSM
    dest1, ptr1, istop1, dstop1 = nav.update_destination(
        pos, state.dest, dq, state.destpointer, nq, state.znav, i,
        state.i_stopsignal, state.d_stopsignal, npar.d_arrived_inter)
    ddest1 = nav.dest_distance(pos, dq, ptr1)
    vd1, znav1, znavp1 = nav.update_nav_state(
        v, ddest1, dest1[:, 2], state.znav, state.znavparams, i, npar)

    # support points: not-last (prev, current, dq[ptr1 .. ptr1 + fwd - 1]),
    # fwd in 2..4; last (1 s back, one step back, current, destination)
    is_last = ptr1 >= nq - 1
    fwd = torch.clamp(nq - ptr1, max=SPL_N_FWD)
    didx = torch.clamp(ptr1[:, None] + torch.arange(SPL_N_FWD, device=dev),
                       0, dq.shape[1] - 1)
    dq_sel = torch.gather(dq[:, :, :2], 1,
                          didx.long()[:, :, None].expand(-1, -1, 2))
    pts_nl = torch.cat([prev[:, None], pos[:, None], dq_sel], dim=1)
    pts_last = torch.cat([back[:, None], prev[:, None], pos[:, None],
                          dest1[:, None, :2],
                          torch.zeros((n, 2, 2), dtype=dtype, device=dev)],
                         dim=1)
    pts6 = torch.where(is_last[:, None, None], pts_last, pts_nl)   # [N, 6, 2]
    m_valid = torch.where(is_last, 4, 2 + fwd)
    t_sites, moments = spl.fit_masked_banded(pts6, m_valid)

    # positions at the SPL_N_PNTS uniform parameters for the nearest-sample
    # search, then the derivatives at the two parameters the force needs
    q20 = spl.uniform_grid(SPL_N_PNTS, dtype, dev)
    S20 = spl.eval_positions(t_sites, pts6, moments, q20)          # [N, 20, 2]
    d2 = ((S20[..., 0] - pos[:, 0, None]) ** 2
          + (S20[..., 1] - pos[:, 1, None]) ** 2)
    # torch.argmin takes the first minimum, as jnp.argmin does
    i_spl = torch.where(is_last, torch.argmin(d2, dim=1), 1)
    ipred = i_spl + torch.where(dest1[:, 2] > 0, SPL_IPRED_LAST, SPL_IPRED)
    ip = torch.clamp(ipred, max=SPL_N_PNTS - 1)
    rows = torch.arange(SPL_N_PNTS, device=dev)
    q_i = torch.sum(torch.where(rows == i_spl[:, None], q20, 0.0), dim=1)
    q_p = torch.sum(torch.where(rows == ip[:, None], q20, 0.0), dim=1)
    S2, dS2, d2S2 = spl.spline_eval(t_sites, pts6, moments,
                                    torch.stack([q_i, q_p], dim=1))

    dx, dy = dS2[:, 0, 0], dS2[:, 0, 1]
    d2x, d2y = d2S2[:, 0, 0], d2S2[:, 0, 1]
    R = torch.sqrt(dx**2 + dy**2) ** 3 / torch.abs(dx * d2y - dy * d2x)
    v_curve = torch.clamp(torch.sqrt(SPL_THETA_COMF * g * R),
                          min=SPL_V_MIN_STABLE)
    v_spl = torch.minimum(v_curve, vd1)
    seg = S2[:, 1] - S2[:, 0]
    seg_len = torch.sqrt(seg[:, 0] ** 2 + seg[:, 1] ** 2)
    f_spl = v_spl[:, None] * seg / torch.where(seg_len > 0, seg_len,
                                               1.0)[:, None]

    # the straight-line fallback (precedence: step 0, arrived, fallback,
    # spline); inactive rows stay out of it, as the JAX gate keeps them
    use_fb = (((ipred >= SPL_N_PNTS) | ~torch.isfinite(f_spl).all(dim=1))
              & ~znav1[:, 2] & (i > 0))
    use_fb = use_fb & state.active
    fx = torch.where(i == 0, vd1 * torch.cos(s[:, PSI]),
                     torch.where(znav1[:, 2], 0.0, f_spl[:, 0]))
    fy = torch.where(i == 0, vd1 * torch.sin(s[:, PSI]),
                     torch.where(znav1[:, 2], 0.0, f_spl[:, 1]))

    # second pass of the queue update and FSM, then the straight line
    dest2, ptr2, istop2, dstop2 = nav.update_destination(
        pos, dest1, dq, ptr1, nq, znav1, i, istop1, dstop1,
        npar.d_arrived_inter)
    ddest2 = nav.dest_distance(pos, dq, ptr2)
    vd2, znav2, znavp2 = nav.update_nav_state(
        v, ddest2, dest2[:, 2], znav1, znavp1, i, npar)
    fbx, fby = F.dest_force_straight(pos[:, 0], pos[:, 1], dest2[:, 0],
                                     dest2[:, 1], vd2, ddest2)

    def sel(a, b):
        return torch.where(use_fb.reshape((-1,) + (1,) * (b.ndim - 1)), a, b)

    new_state = state.replace(
        dest=sel(dest2, dest1), destpointer=sel(ptr2, ptr1),
        znav=sel(znav2, znav1), znavparams=sel(znavp2, znavp1),
        i_stopsignal=sel(istop2, istop1), d_stopsignal=sel(dstop2, dstop1))
    return sel(fbx, fx), sel(fby, fy), new_state


DEST_FORCES = {"straight": dest_force_straight,
               "direct": dest_force_straight,
               "hm": dest_force_hm,
               "spline": dest_force_spline}


def dest_force_kw(dest_force, params) -> dict:
    """What an engine decides once, when it is built, for its destination
    force: the spline force's lookback (`spline_lookback`); nothing for
    the others."""
    if dest_force is dest_force_spline:
        return {"lookback": spline_lookback(params)}
    return {}


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

# the pairs one call of the generic culled path evaluates at most (its
# tiles' temporaries take ~20 x 4 bytes a pair in float32)
GENERIC_TILE_PAIRS = 1 << 24


# the pair kernels NeighborConfig.backend selects for the named families
# (the JAX package's names)
KERNEL_BACKENDS = ("pallas", "pallas_unrolled", "pallas_db")
# the generic culled path of custom force tiles, which has no kernel in
# either package (`Engine.repulsive_sum_neighbors_generic`)
GENERIC_BACKEND = "xla"
BACKENDS = KERNEL_BACKENDS + (GENERIC_BACKEND,)
# JAX-only backends: the Pallas interpreter, whose role the plain version
# plays in the port
JAX_ONLY_BACKENDS = ("interpret", "interpret_unrolled", "interpret_db")
# the hint for a backend the port runs as each kernel's plain version
PLAIN_VERSION_HINT = (" (the port runs each kernel's plain version on CPU "
                      "tensors: pick the kernel by name and put the state "
                      "on the CPU)")


@dataclass(frozen=True)
class NeighborConfig:
    """Configuration of the block-sparse neighbor force path.

    cutoff : interaction radius [m]; the twod field decays as
        exp(-rho/sigma), sigma <= ~5.5 m, so 50-60 m bounds the dropped
        force near 1e-4. The legacy field needs ~100 m: its forward decay
        is much slower for fast sources.
    block : receivers per block. The CUDA kernels take 64, 128 and 256
        (`ops.pair_forces.KERNEL_BLOCKS`) and raise for any other value;
        CPU tensors (the plain version) take any.
    block_src : sources per block (0: `block`; must divide `block`, and
        be a multiple of 8).
    kb : capacity of the neighbor-block table (overflow drops the
        farthest blocks and is flagged).
    backend : the pair kernel on CUDA tensors: "pallas" (K1,
        `ops.pair_forces.pair_forces_neighbors`), "pallas_unrolled" (K2,
        every source tile staged up front, never screened) or "pallas_db"
        (K3, a ring of tiles, always tile-screened at `cutoff`, needs
        block_src == block). The names are the JAX package's; CPU tensors
        run each kernel's plain version in the same form. "xla" is the
        generic culled path of custom force tiles (external models), the
        only backend they take; `Engine.create` refuses it for the named
        families, whose pairs always go through a kernel on the card.
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

    # the JAX package's positional order (cyclistsocialforce_tpu.engine
    # NeighborConfig.__init__)
    cutoff: float = 60.0
    block: int = 128
    kb: int = 16
    backend: str = "pallas"
    rebuild_every: int = 1
    skin: float | None = None
    v_max: float = 10.0
    t_s: float = 0.01
    sub: int = 0
    screen: bool = True
    rebuild_mode: str = "chunked"
    block_src: int = 0
    table_chunk: int = 0
    row_segments: int = 1

    def __post_init__(self):
        bs = int(self.block_src) or int(self.block)
        if int(self.block) % bs != 0 or bs % 8 != 0:
            raise ValueError(f"block_src ({bs}) must divide block "
                             f"({self.block}) and be a multiple of 8")
        if self.backend not in BACKENDS:
            hint = (PLAIN_VERSION_HINT if self.backend in JAX_ONLY_BACKENDS
                    else "")
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


def _registered(registry: dict, name: str, what: str):
    """The function a registry name names."""
    if name not in registry:
        raise ValueError(f"{what} {name!r} is not one of "
                         f"{sorted(registry)}")
    return registry[name]


def pair_family_of(rep_force):
    """The pair family of a repulsive tile: "twod" and "legacy" for the
    named fields, "custom" for any other callable, None without one."""
    if rep_force is None:
        return None
    for name, fn in REP_FORCES.items():
        if rep_force is fn:
            return name
    return "custom"


def _check_backend(family, cfg: NeighborConfig | None):
    """A custom tile is culled only by the generic path (backend "xla"),
    the named families only by a pair kernel."""
    if cfg is None:
        return
    if family == "custom" and cfg.backend != GENERIC_BACKEND:
        raise ValueError(
            "custom force tiles (e.g. external models) support neighbor "
            "culling only with the 'xla' backend (the generic "
            "per-receiver-block path preserves arbitrary rep_reduce "
            "hooks); the pair kernels serve the named families ('twod', "
            "'legacy')")
    if family in REP_FORCES and cfg.backend == GENERIC_BACKEND:
        raise ValueError(
            f"backend {GENERIC_BACKEND!r} is the generic path of custom "
            f"force tiles; the {family!r} field goes through one of "
            f"{KERNEL_BACKENDS}{PLAIN_VERSION_HINT}")


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
                         count=None, field_pairs=None):
    """[2, B*block] sorted forces from cell-sorted packs through the
    kernel `cfg.backend` names: the CUDA kernel (float32) for CUDA
    tensors, its plain version in the packs' dtype for CPU tensors. The
    screens compare with `cfg.cutoff`, without the skin; K3 always reads
    the per-source field columns. `mixed` selects each source row's field
    family by its column 13 (the legacy field's form); it excludes
    `uniform`. `count` is the table's valid entries per row where the
    caller has them (`build_neighbor_cache`); `field_pairs` the counter K1
    adds its evaluated pairs to (`Engine.field_pairs`)."""
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
            cutoff=cfg.cutoff, field_pairs=field_pairs, **kw)
    return out.to(dtype)


@dataclass(frozen=True)
class RoadElements:
    """Stacked road-edge geometry (counterpart of the JAX package's
    `engine.RoadElements`): vertices [V, 2], validity weights [V], and the
    repulsion's F_0 and sigma per vertex [V]. Built on the host by
    `road.build_road_elements`; an engine keeps its own copy in the
    state's dtype and device (`Engine.road_tensors`)."""

    vertices: torch.Tensor
    weights: torch.Tensor
    F_0: torch.Tensor
    sigma: torch.Tensor

    def to(self, dtype=None, device=None) -> "RoadElements":
        return RoadElements(*(getattr(self, f.name).to(dtype=dtype,
                                                       device=device)
                              for f in dataclasses.fields(self)))


@dataclass(frozen=True)
class ScriptedTraj:
    """Prescribed trajectories of uncontrolled agents (counterpart of the
    JAX package's `engine.ScriptedTraj`; reference UncontrolledVehicle,
    vehicle.py:920-987): a scripted agent ignores every force and replays
    `traj[uid, i]` at its step counter i, holding its last state once the
    script runs out, while it still emits its repulsive field on everyone
    else (give it car-like field parameters through per-agent params).

    traj [N, T, 8] float, mask [N] bool (which agents are scripted),
    length [N] int32 (valid steps per agent). The tables are indexed by
    the persistent agent uid, so a replay follows its agent through any
    row permutation (the sorted-resident chunks). An engine keeps its own
    copy in the state's dtype on its device (`Engine.scripted_tensors`)."""

    traj: torch.Tensor
    mask: torch.Tensor
    length: torch.Tensor

    @classmethod
    def create(cls, n: int, trajectories: dict, dtype=torch.float64,
               device="cuda") -> "ScriptedTraj":
        """Build from {agent index: [T_a, k] array-like, k <= 8} on the
        host (missing trailing state entries are zero)."""
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        t_max = max((np.shape(t)[0] for t in trajectories.values()),
                    default=1)
        traj = np.zeros((n, t_max, STATE_DIM), dtype=np_dtype)
        mask = np.zeros((n,), dtype=bool)
        length = np.zeros((n,), dtype=np.int32)
        for a, t in trajectories.items():
            t = np.asarray(t, dtype=np_dtype)
            traj[a, :t.shape[0], :t.shape[1]] = t
            mask[a] = True
            length[a] = t.shape[0]
        return cls(traj=torch.from_numpy(traj).to(device),
                   mask=torch.from_numpy(mask).to(device),
                   length=torch.from_numpy(length).to(device))

    def to(self, dtype=None, device=None) -> "ScriptedTraj":
        """The tables on `device`, the trajectories in `dtype`."""
        return ScriptedTraj(traj=self.traj.to(dtype=dtype, device=device),
                            mask=self.mask.to(device=device),
                            length=self.length.to(device=device))


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


_STATE_FIELDS = _ALL_AGENT_FIELDS + ("t_glob", "key")


def _map_state(fn, state: AgentState) -> AgentState:
    return state.replace(**{f: fn(getattr(state, f))
                            for f in _STATE_FIELDS})


def _copy_state(dst: AgentState, src: AgentState):
    """Copy every field of `src` into the tensors of `dst`, in place."""
    for f in _STATE_FIELDS:
        getattr(dst, f).copy_(getattr(src, f))


def _check_params_on(params, device):
    """A CUDA-graph capture takes no host-to-device copy: every per-agent
    parameter tensor, and a shared table's (`ip_zoh_lut`), must already
    lie on the state's device."""
    for f in dataclasses.fields(params):
        val = getattr(params, f.name)
        parts = val if isinstance(val, tuple) else (val,)
        v = next((t for t in parts if isinstance(t, torch.Tensor)
                  and t.device != device), None)
        if v is not None:
            raise ValueError(
                f"params.{f.name} is on {v.device} but the state is on "
                f"{device}: a graphed simulate copies nothing from the "
                f"host inside a step. Build per-agent parameters with "
                f"as_population(..., device={str(device)!r}), or run "
                f"simulate(graph=False)")


# the kernels whose launches a `ChunkRunner` counts in its captures
COUNTED_KERNELS = PF.KERNELS + AS.KERNELS


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
    shared parameters, the NeighborConfig, the kernel form, and the phase
    of the global step clock at the chunk's start modulo the engine's
    `clock_period` (a model step that depends on the clock, the
    stochastic balancing rider's resampling cadence, reads it on the host:
    `Engine.run_chunk(t0=)`). An engine keeps its runners until one of
    those attributes is assigned, and `Engine.with_params` starts a new
    engine without them.

    Launch counters: the warm-up chunk launches its `k` kernels through
    their wrappers, which count them. The capture runs the wrappers again,
    but records the launches instead of running them (`captured`, the
    recorded launches per kernel), and a replay runs them without a
    wrapper: the runner counts its `replays`, and `launches` is their
    product."""

    def __init__(self, engine, state: AgentState, cache, k: int,
                 presorted: bool, mode, phase=None):
        # a weak reference: the engine owns its runners, and a cycle
        # would leave a dropped engine's graphs to the cyclic collector,
        # which may destroy them while another graph is being captured
        # (CUDA refuses that and drops the capture)
        self.engine, self.k = weakref.proxy(engine), k
        self.presorted, self.mode, self.phase = presorted, mode, phase
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
        recorded = PF.captured_counts(COUNTED_KERNELS)
        self._capture()
        # the launches the capture recorded, per counted kernel
        self.captured_by = dict(zip(COUNTED_KERNELS, (
            a - b for a, b in zip(PF.captured_counts(COUNTED_KERNELS),
                                  recorded))))
        self.captured = tuple(self.captured_by[fn] for fn in PF.KERNELS)
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
                                     self.overflow, t0=self.phase)

    def _capture(self):
        """Capture `_body` into `self.graph`; its result, which lives in
        the graph's memory, becomes `self.state_out`."""
        device = self.state_in.device
        self.engine.check_params_on(device)
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

    def run(self, state: AgentState, cache, probe=None):
        """One chunk from `state` on the table `cache`: (final state,
        record rows), both static tensors that the next `run`
        overwrites. `probe` (`tracing.probe`) times the copies in and
        the replay."""
        with tracing.span(probe, "load"):
            self._load(state, cache)
        with tracing.span(probe, "replay"):
            self._replay()
        self.replays += 1
        return self.state_out, self.rows

    def launches(self, kernels=PF.KERNELS) -> tuple:
        """Launches of each of `kernels` (the pair kernels, or
        `ops.agent_step.KERNELS`) made by this runner's replays, in their
        order."""
        return tuple(self.replays * self.captured_by[fn] for fn in kernels)


class Engine(nn.Module):
    """One shared space with one homogeneous-model agent population and a
    repulsive field, dense or culled: a named one ("twod" or "legacy",
    culled through the pair kernels) or a custom tile (an external model,
    culled through `repulsive_sum_neighbors_generic`). Build with
    `Engine.create`.

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

    # may `simulate` keep the rows in cell-sorted order within a chunk
    # (an engine's `create(sorted_resident=)` sets its own)
    sorted_resident = True

    # what a captured chunk and the kept pack columns read from the engine
    _FROZEN_BY_A_CAPTURE = frozenset((
        "params", "model_step", "state_widths", "dest_force", "dest_kw",
        "rep_force", "pair_family", "neighbors", "full_fov", "uniform_pair",
        "priority_p2r", "rep_chunk", "step_constants", "road",
        "clock_hook", "kernel_hook", "scripted", "rep_reduce",
        "combine_forces"))

    def __init__(self, params, model_step, state_widths, dest_force,
                 rep_force, pair_family, neighbors, full_fov: bool,
                 uniform_pair, priority_p2r: bool = False,
                 rep_chunk: int | None = None, dest_kw=None,
                 step_constants=None, road=None, clock_hook=None,
                 kernel_hook=None, scripted=None, rep_reduce=None,
                 combine_forces=None, sorted_resident: bool = True):
        super().__init__()
        self.params = params
        self.model_step = model_step
        self.state_widths = state_widths
        self.dest_force = dest_force
        # what the destination force decided once (`dest_force_kw`)
        self.dest_kw = dest_kw if dest_kw is not None else {}
        self.rep_force = rep_force
        # "twod", "legacy", "custom" (a callable tile) or None (no pair
        # stage: the model declares no repulsive force)
        self.pair_family = pair_family
        self.scripted = scripted             # ScriptedTraj or None
        # the external-model hooks: how the pair channels reduce over the
        # sources (None: `ops.forces.sum_sources`) and how the reduced
        # repulsion meets the destination force (None:
        # `ops.forces.clamp_add_dest`)
        self.rep_reduce = rep_reduce
        self.combine_forces = combine_forces
        self.sorted_resident = bool(sorted_resident)
        self.neighbors = neighbors
        self.full_fov = full_fov
        self.uniform_pair = uniform_pair
        self.priority_p2r = priority_p2r
        self.rep_chunk = rep_chunk
        # the model's `step_constants` hook, or None (`kept_constants`)
        self.step_constants = step_constants
        self.road = road                     # RoadElements or None
        # the model's `clock_period` hook, or None (the step never reads
        # the global step clock on the host)
        self.clock_hook = clock_hook
        # the model's `agent_kernels` hook, or None (no step takes the
        # per-agent kernels: `agent_kernels`)
        self.kernel_hook = kernel_hook
        # what the engine builds once and keeps (`kept`): the constant
        # pack columns, the road, the scripts, the model's constants, the
        # per-agent kernels' answer
        self._columns = {}
        self._runners = {}    # captured program -> ChunkRunner

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name in self._FROZEN_BY_A_CAPTURE and "_runners" in self.__dict__:
            self._columns.clear()
            self._runners.clear()

    @classmethod
    def create(cls, params, model, road=None, dest_force=None,
               rep_force=None, priority_rule: str = "unregulated",
               rep_chunk: int | None = None, scripted=None,
               rep_reduce=None, combine_forces=None,
               neighbors: NeighborConfig | None = None,
               sorted_resident: bool | None = None):
        """Build an engine from a model module (`models.MODELS`, or an
        external model such as `external`). The parameters are the JAX
        package's, in its order.

        road : a `RoadElements` (`road.build_road_elements`): every
            vertex repels every agent, added after the repulsive forces.
        dest_force, rep_force : registry names (`DEST_FORCES`,
            `REP_FORCES`) or callables (the reference's strategy
            injection: `dest_force(params, state) -> (fx, fy, state)`,
            `rep_force(params, src, recv) -> ([S, R], [S, R])` over (x, y,
            psi, v) bundles); omitted, the model's `DEST_FORCE` /
            `REP_FORCE` apply (bicycle2d: "straight", "legacy"). A
            callable tile is the "custom" pair family.
        priority_rule : "p2r" (priority to the right) masks out every
            source to the receiver's left in the pair stage; any other
            value leaves the field unregulated, as in the JAX package.
        rep_chunk : receivers per chunk of the dense pair stage (None: all
            at once); it must divide N.
        scripted : a `ScriptedTraj` of agents that replay a script.
        rep_reduce, combine_forces : the external-model hooks (given, or
            the model's `REP_REDUCE` / `COMBINE_FORCES`): `rep_reduce(fx,
            fy, tracked) -> (fx, fy)` over the source axis, and
            `combine_forces(frx, fry, fdx, fdy) -> (fx, fy)`.
        neighbors : a NeighborConfig selects the culled pair stage; None
            the dense one. The named families take the kernel backends,
            a custom tile only "xla" (the generic culled path).
        sorted_resident : may `simulate` keep the rows in cell-sorted
            order within a chunk (None: the model's `SORTED_RESIDENT`,
            True without one; False for a custom tile, which the generic
            path culls in the rows' own order whatever this says)."""
        if scripted is not None and not isinstance(scripted, ScriptedTraj):
            raise TypeError(f"scripted must be a ScriptedTraj, got "
                            f"{type(scripted).__name__}")
        dest = dest_force if dest_force is not None else model.DEST_FORCE
        if isinstance(dest, str):
            dest = _registered(DEST_FORCES, dest, "destination force")
        rep = rep_force if rep_force is not None else model.REP_FORCE
        if isinstance(rep, str):
            rep = _registered(REP_FORCES, rep, "repulsive force")
        family = pair_family_of(rep)
        _check_backend(family, neighbors)
        if sorted_resident is None:
            sorted_resident = (family != "custom" and bool(
                getattr(model, "SORTED_RESIDENT", True)))
        return cls(params=params, model_step=model.step,
                   state_widths=getattr(model, "STATE_WIDTHS", None),
                   dest_force=dest, dest_kw=dest_force_kw(dest, params),
                   rep_force=rep, pair_family=family, neighbors=neighbors,
                   full_fov=_hfov_is_full(params),
                   uniform_pair=(_uniform_pair_params(params)
                                 if family == "twod" else None),
                   priority_p2r=(priority_rule == "p2r"),
                   rep_chunk=rep_chunk,
                   step_constants=getattr(model, "step_constants", None),
                   road=road, clock_hook=getattr(model, "clock_period",
                                                 None),
                   kernel_hook=getattr(model, "agent_kernels", None),
                   scripted=scripted,
                   rep_reduce=(rep_reduce
                               or getattr(model, "REP_REDUCE", None)),
                   combine_forces=(combine_forces
                                   or getattr(model, "COMBINE_FORCES",
                                              None)),
                   sorted_resident=sorted_resident)

    def with_params(self, params):
        """Engine with `params` swapped in and the fields derived from
        them (`full_fov`, `uniform_pair`, `dest_kw`) recomputed: the
        kernels take the first two as compile-time forms, so stale values
        would apply the old constants or FOV elision to the new
        parameters, and the spline force's lookback follows t_s."""
        return type(self)(
            params=params, model_step=self.model_step,
            state_widths=self.state_widths, dest_force=self.dest_force,
            dest_kw=dest_force_kw(self.dest_force, params),
            rep_force=self.rep_force, pair_family=self.pair_family,
            neighbors=self.neighbors, full_fov=_hfov_is_full(params),
            uniform_pair=(_uniform_pair_params(params)
                          if self.pair_family == "twod" else None),
            priority_p2r=self.priority_p2r, rep_chunk=self.rep_chunk,
            step_constants=self.step_constants, road=self.road,
            clock_hook=self.clock_hook, kernel_hook=self.kernel_hook,
            scripted=self.scripted, rep_reduce=self.rep_reduce,
            combine_forces=self.combine_forces,
            sorted_resident=self.sorted_resident)

    # ---- the dense pair stage ----

    def _src_bundle(self, state: AgentState):
        """The source side of the pair stage: (x, y, psi, v) [N] each."""
        s = state.s
        return (s[:, X], s[:, Y], s[:, PSI], s[:, V])

    def repulsive_sum(self, state: AgentState, src=None, idx_src=None,
                      active_src=None, hfov_src=None, recv_offset=0):
        """Summed repulsive force (fx, fy) [N] on every agent of `state`
        (the receivers) from every source: the [S, N] (or, with
        `rep_chunk`, [S, rep_chunk] receiver-chunk) tiles of the field,
        masked by `ops.forces.untracked_foes_tile` and reduced over the
        sources (`reduce_sources`).

        By default the sources are the receivers. A sharded step
        (`parallel`) passes the gathered population instead: `src` the
        (x, y, psi, v) bundle of every source, `idx_src` their global
        indices, `active_src` and `hfov_src` their activity and half
        field of view, while `state` is a shard whose rows hold the global
        indices recv_offset, recv_offset + 1, ... (a receiver never sees
        itself)."""
        n = state.n
        s = state.s
        if src is None:
            src = self._src_bundle(state)
            idx_src = torch.arange(n, device=s.device)
            active_src = state.active
            hfov_src = _per_agent(self.params.hfov, n, s)
        idx = torch.arange(n, device=s.device)

        def recv_tile(ri):
            recv = (s[ri, X], s[ri, Y], s[ri, PSI], s[ri, V])
            fpx, fpy = self.rep_force(self.params, src, recv)
            untracked = F.untracked_foes_tile(
                src[0], src[1], idx_src, active_src, hfov_src, recv[0],
                recv[1], recv[2], ri + recv_offset, state.active[ri],
                priority_p2r=self.priority_p2r)
            return self.reduce_sources(fpx, fpy, ~untracked)

        c = self.rep_chunk
        if c is None or c >= n:
            return recv_tile(idx)
        if n % c != 0:
            raise ValueError(f"rep_chunk={c} must divide N={n}.")
        parts = [recv_tile(ri) for ri in idx.reshape(n // c, c)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    # ---- the culled pair stage ----

    def kept(self, key, build):
        """`build()`, made once per `key` and kept by the engine until a
        field that a capture reads changes (`_FROZEN_BY_A_CAPTURE`)."""
        if key not in self._columns:
            self._columns[key] = build()
        return self._columns[key]

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
            return self.kept((name, shared, n, dtype, dev), build)

        def b(name):
            v = values[name]
            if per_agent(v):
                # per-agent table in original row order: index by uid so
                # a row's parameters follow it through permutations; a
                # uid past the table reads its last row, as JAX's
                # clamped gather does (the SUMO bridge numbers entrants
                # on from the capacity)
                return v.to(device=dev, dtype=dtype)[
                    state.uid.long().clamp_max(v.shape[0] - 1)]
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
                                    mixed=mixed, count=count,
                                    field_pairs=self.field_pairs(
                                        src_sorted.device))

    def field_pairs(self, device):
        """The int64 [1] counter on a card `device` to which K1 adds the
        pairs whose field it evaluates, every call this engine makes (kept
        with the pack columns: a captured chunk adds to it by address);
        None on the CPU. `simulate` reports its growth as the counter
        `field_pairs` where it records (`tracing`)."""
        device = torch.device(device)
        if device.type != "cuda":
            return None
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return self.kept(("field_pairs", device), lambda: torch.zeros(
            1, dtype=torch.int64, device=device))

    def generic_blocks_per_call(self) -> int:
        """Receiver blocks per call of the generic culled path: as many
        as keep one call's [kb * block_src, block] tiles within
        GENERIC_TILE_PAIRS pairs (at least one)."""
        cfg = self.neighbors
        per_block = cfg.kb * cfg.block_src * cfg.block
        return max(1, GENERIC_TILE_PAIRS // per_block)

    def repulsive_sum_neighbors_generic(self, state: AgentState,
                                        cache=None):
        """Culled pairwise forces (fx, fy) [N] of a custom tile (external
        models, reference external.py:44-182; the JAX package's
        `repulsive_sum_neighbors_generic`): each receiver block gathers
        the (x, y, psi, v) bundles of its kb * block_src table sources
        and evaluates `rep_force` and the reduction (`reduce_sources`)
        over that one [kb * block_src, block] tile, so a receiver-side
        reduction of any kind (the Kaths nearest-neighbour min) holds
        exactly. Invalid table slots are folded into the source mask.

        Per-agent parameter tensors are viewed on the RECEIVER side: the
        tile sees params whose [N, ...] tensors are sliced to its
        receiver block (a custom tile reads per-agent parameters at the
        receivers). The blocks run `generic_blocks_per_call()` at a time
        under `torch.func.vmap`, one block per hook call as in the JAX
        package's `lax.map` (1-D `src` [kb * block_src], `recv`
        [block]), which bounds a call's tiles to GENERIC_TILE_PAIRS
        pairs. The path has no kernel in either package: it runs as
        PyTorch operations on any device."""
        cfg = self.neighbors
        n = state.n
        blk, bs = cfg.block, cfg.block_src
        npad = -(-n // blk) * blk
        s = state.s
        dev = s.device
        if cache is None:
            cache = self.neighbor_cache(state)
        perm, nbr, valid = cache[0], cache[1], cache[2]
        perm = perm.long()

        def pad(a, fill=None):
            """`a` padded to npad rows (by `fill`, or its first row) and
            put in the table's cell-sorted order."""
            if npad != n:
                tail = (a[:1] if fill is None
                        else torch.full((1,), fill, dtype=a.dtype,
                                        device=dev))
                a = torch.cat([a, tail.expand((npad - n,) + a.shape[1:])])
            return a[perm]

        # pad rows sit at agent 0's position, inactive
        x, y = pad(s[:, X]), pad(s[:, Y])
        psi, v = pad(s[:, PSI], 0.0), pad(s[:, V], 0.0)
        act = pad(state.active, False)
        hfov = pad(_per_agent(self.params.hfov, n, s), 1.0)
        idx = torch.arange(npad, device=dev)[perm]
        nblk = npad // blk

        # receiver-block views of the per-agent parameter tensors
        names, blocked = [], []
        for f in dataclasses.fields(self.params):
            a = getattr(self.params, f.name)
            if isinstance(a, torch.Tensor) and a.ndim >= 1:
                if a.shape[0] != n:
                    raise ValueError(
                        f"params.{f.name} has {a.shape[0]} rows for {n} "
                        f"agents")
                names.append(f.name)
                blocked.append(pad(a.to(dev)).reshape((nblk, blk)
                                                      + a.shape[1:]))

        def recv_block(xs, ys, psis, vs, ids, src_ok, hfovs, xr, yr, pr,
                       vr, ir, ar, *leaves):
            """One receiver block's tile, reduced (the hook contract)."""
            params = dataclasses.replace(self.params,
                                         **dict(zip(names, leaves)))
            fpx, fpy = self.rep_force(params, (xs, ys, psis, vs),
                                      (xr, yr, pr, vr))
            untracked = F.untracked_foes_tile(
                xs, ys, ids, src_ok, hfovs, xr, yr, pr, ir, ar,
                priority_p2r=self.priority_p2r)
            return self.reduce_sources(fpx, fpy, ~untracked)

        batched = torch.func.vmap(recv_block)
        lane = torch.arange(bs, device=dev)
        recv = [a.reshape(nblk, blk) for a in (x, y, psi, v, idx, act)]
        per_call = self.generic_blocks_per_call()
        outs = []
        for lo in range(0, nblk, per_call):
            hi = min(nblk, lo + per_call)
            take = (nbr[lo:hi].long()[:, :, None] * bs
                    + lane).reshape(hi - lo, -1)
            src_ok = act[take] & valid[lo:hi].repeat_interleave(bs, dim=1)
            outs.append(batched(
                x[take], y[take], psi[take], v[take], idx[take], src_ok,
                hfov[take], *(a[lo:hi] for a in recv),
                *(b[lo:hi] for b in blocked)))
        frx = torch.cat([o[0] for o in outs]).reshape(npad)
        fry = torch.cat([o[1] for o in outs]).reshape(npad)
        fx = torch.empty_like(frx)
        fy = torch.empty_like(fry)
        fx[perm] = frx
        fy[perm] = fry
        return fx[:n], fy[:n]

    def repulsive_sum_neighbors(self, state: AgentState, cache=None,
                                presorted: bool = False):
        """Culled pairwise forces (fx, fy) [N]. `cache` is a prebuilt
        `neighbor_cache` (amortized rebuilds). With presorted=True the
        rows are already in the cache's cell-sorted order (the
        sorted-resident path of `simulate`; N a multiple of the block):
        the pack gather and the force scatter are skipped. A custom tile
        takes the generic path (`repulsive_sum_neighbors_generic`), which
        never runs presorted."""
        if self.pair_family == "custom":
            return self.repulsive_sum_neighbors_generic(state, cache)
        src_pack, recv_pack = self.pack_pair_fields(
            state, self.pair_rows(state.n))
        return self.pair_stage(state, src_pack, recv_pack, cache, presorted)

    def pair_rows(self, n: int) -> int:
        """Rows of the pair packs of `n` agents: n padded to a whole
        receiver block."""
        block = self.neighbors.block
        return -(-n // block) * block

    def pair_stage(self, state: AgentState, src_pack, recv_pack,
                   cache=None, presorted: bool = False):
        """The culled pair sums (fx, fy) [N] of the row-order packs of
        `state` (`pair_rows` rows, `pack_pair_fields`' layout): gathered
        into the table's cell-sorted order, through the pair kernel, and
        scattered back; with presorted=True the rows already are in that
        order and neither is done. `cache` as `repulsive_sum_neighbors`."""
        n = state.n
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

    def destination_forces(self, state: AgentState, params=None):
        """(fx, fy, state) of the destination force, the state carrying
        its queue and navigation-FSM updates; `params` the per-row
        parameters where they are not the engine's (a shard's rows)."""
        return self.dest_force(self.params if params is None else params,
                               state, **self.dest_kw)

    def reduce_sources(self, fx_pair, fy_pair, tracked):
        """The pair channels reduced over the source axis: the engine's
        `rep_reduce` hook, or the masked sum."""
        return (self.rep_reduce or F.sum_sources)(fx_pair, fy_pair, tracked)

    def calc_forces(self, state: AgentState, nbr_cache=None,
                    presorted: bool = False):
        """Total social force per agent: (fx, fy, state), the state
        carrying the navigation-FSM updates of the destination force
        (reference intersection.py:747-864)."""
        fx, fy, state = self.destination_forces(state)
        fx, fy = self.mask_scripted(state, fx, fy)
        rep = None
        if self.pair_family is not None and state.n > 1:
            if self.neighbors is not None:
                rep = self.repulsive_sum_neighbors(state, nbr_cache,
                                                   presorted=presorted)
            else:
                rep = self.repulsive_sum(state)
        fx, fy = self.add_pair_and_road(state, fx, fy, rep)
        return fx, fy, state

    def mask_scripted(self, state: AgentState, fx, fy):
        """Scripted agents take no destination force (reference
        vehicle.py:985-986), so the clamp zeroes the repulsion they
        receive too."""
        if self.scripted is None:
            return fx, fy
        smask = self.scripted_tensors(state).mask[state.uid.long()]
        return torch.where(smask, 0.0, fx), torch.where(smask, 0.0, fy)

    def add_pair_and_road(self, state: AgentState, fx, fy, rep=None):
        """The destination forces (fx, fy) combined with the pair stage's
        (frx, fry) `rep` (None: no pair stage) through the
        `combine_forces` hook, plus the road's edge force."""
        if rep is not None:
            fx, fy = (self.combine_forces or F.clamp_add_dest)(rep[0], rep[1],
                                                               fx, fy)
        if self.road is not None:
            road = self.road_tensors(state)
            rx, ry = F.road_edge_force(state.s[:, X], state.s[:, Y],
                                       road.vertices, road.weights,
                                       road.F_0, road.sigma)
            fx, fy = fx + rx, fy + ry
        return fx, fy

    def road_tensors(self, state: AgentState) -> RoadElements:
        """The road in the state's dtype on its device, built once and kept
        with the pack columns (a captured chunk reads it by address)."""
        return self.kept(("road", state.s.dtype, state.device),
                         lambda: self.road.to(state.s.dtype, state.device))

    def scripted_tensors(self, state: AgentState) -> ScriptedTraj:
        """The script tables in the state's dtype on its device, built
        once and kept with the pack columns (a captured chunk reads them
        by address)."""
        def build():
            sc = self.scripted
            if sc.mask.shape[0] < state.n:
                raise ValueError(
                    f"the scripts cover {sc.mask.shape[0]} agents and the "
                    f"state has {state.n}: ScriptedTraj.create(n=...) "
                    f"takes every row, padding rows included")
            return sc.to(state.s.dtype, state.device)

        return self.kept(("scripted", state.s.dtype, state.device), build)

    def finish_step(self, before: AgentState, new: AgentState):
        """Freeze inactive agents, replay the scripted agents, advance the
        step counters and record the position ring slot of the new global
        step (out of place). A scripted agent takes `traj[uid, i]` at its
        incremented counter i while i < its length and holds its pre-step
        state after (reference vehicle.py:973-977)."""
        merged = _freeze_inactive(before.active, before, new)
        i = merged.i + before.active.to(merged.i.dtype)
        if self.scripted is not None:
            sc = self.scripted_tensors(before)
            uid = merged.uid.long()
            length = sc.length[uid]
            smask = sc.mask[uid]
            idx = torch.clamp(torch.minimum(i, length - 1), min=0).long()
            replay = sc.traj[uid, idx]
            live = i < length
            s = torch.where((smask & live)[:, None], replay, merged.s)
            s = torch.where((smask & ~live)[:, None], before.s, s)
            merged = merged.replace(s=s)
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

    def check_state(self, state: AgentState):
        """Reject a state built for another model."""
        _check_state_widths(self.state_widths, state)

    def check_params_on(self, device):
        """Raise unless every per-agent parameter tensor lies on `device`
        (what a captured step reads)."""
        _check_params_on(self.params, device)

    def kept_constants(self, hook, params, state: AgentState,
                       group: int = 0) -> dict:
        """The keyword tensors of a model step that no step changes
        (`hook(params, dtype, device)`, a model's `step_constants`, or {}
        without one), built once per group, dtype and device and kept in
        `_columns` with the pack columns: a captured chunk reads them by
        address, so they live as long as the engine's runners."""
        if hook is None:
            return {}
        return self.kept(("step_constants", group, state.s.dtype,
                          state.device),
                         lambda: hook(params, state.s.dtype, state.device))

    def clock_period(self) -> int:
        """How often the step's dependence on the global step clock
        repeats beyond its random streams (the model's `clock_period`
        hook; 1 without one): a chunk's program depends on the clock's
        phase modulo this at the chunk's start."""
        return self.clock_hook(self.params) if self.clock_hook else 1

    def _clock_kw(self, hook, params, t_host) -> dict:
        """`t_host` for a model step that reads the clock on the host."""
        if hook is None or t_host is None or hook(params) <= 1:
            return {}
        return {"t_host": t_host}

    def dynamics(self, state: AgentState, fx, fy, t_host=None,
                 params=None) -> AgentState:
        """One dynamics step of every agent under the forces (fx, fy);
        `t_host` is the global step where the caller knows it, `params`
        as for `destination_forces`."""
        return self.model_step(self.params if params is None else params,
                               state, fx, fy,
                               **self.kept_constants(self.step_constants,
                                                     self.params, state),
                               **self._clock_kw(self.clock_hook, self.params,
                                                t_host))

    def agent_kernels(self, state: AgentState):
        """The per-agent kernels a step of `state` takes (an
        `ops.agent_step.AgentKernels`), or None: a float32 state of more
        than one row on a CUDA device, and an engine that takes its model's
        kernels there (`kernels_on`). Every other step, and every step of a
        CPU state, goes through the engine's torch functions."""
        if not (state.s.is_cuda and state.s.dtype == torch.float32
                and state.n > 1):
            return None
        return self.kernels_on(state.device, state.hist_len)

    def kernels_on(self, device, hist_len: int):
        """The kernels the model declares (its `agent_kernels(params)`
        hook) where the engine takes them on `device` with a position ring
        of `hist_len` slots, else None: the declared destination force is
        the engine's, the field one of the declared families culled
        through a pair kernel, the parameters the kernels read shared
        (`ops.agent_step.takes_params`: per-rider pair columns allowed as
        tables on `device`), no road, scripts or force hooks; and for the
        spline a ring that holds its 1 s lookback and the step before it
        (a shorter one keeps the torch chain, which warns that it reads
        wrapped samples). The engine decides once per device and keeps the
        answer with its pack columns, which it drops when a field the
        answer reads changes."""
        device = torch.device(device)

        def admit():
            k = self.kernel_hook(self.params) if self.kernel_hook else None
            takes = (k is not None and DEST_FORCES[k.dest] is self.dest_force
                     and self.pair_family in k.families
                     and self.neighbors is not None and self.road is None
                     and self.scripted is None and self.rep_reduce is None
                     and self.combine_forces is None
                     and not getattr(self.params, "dest_force", None)
                     and not getattr(self.params, "rep_force", None)
                     and AS.takes_params(self.params, device, k.fields))
            return k if takes else None

        k = self.kept(("agent_kernels", device), admit)
        if k is not None and k.dest == "spline" and \
                hist_len <= self.dest_kw["lookback"]:
            return None
        return k

    def fused_step(self, state: AgentState, kernels, nbr_cache=None,
                   presorted: bool = False):
        """One step through the per-agent kernels `kernels`
        (`agent_kernels`): `agent_pre`, the pair stage (`pair_stage`) and
        the post kernel; (state, fx, fy) as `step_with_forces`. On CPU
        tensors the wrappers run their plain versions (the torch
        functions), so the result is the torch chain's bit for bit; the
        fields the step does not change are the argument's own tensors."""
        pre = AS.agent_pre(self, state, self.pair_rows(state.n))
        frx, fry = self.pair_stage(state, pre.src_pack, pre.recv_pack,
                                   nbr_cache, presorted)
        return AS.POST_KERNELS[kernels.post](self, state, pre, frx, fry)

    def step_with_forces(self, state: AgentState, nbr_cache=None,
                         presorted: bool = False, t_host=None):
        """One full step; returns (state, fx, fy) with the applied
        forces. `t_host`: the global step (state.t_glob) as the caller
        knows it on the host, or None (a clock-dependent model then
        decides on the device). A step that takes the per-agent kernels
        (`agent_kernels`) goes through them (`fused_step`)."""
        self.check_state(state)
        kernels = self.agent_kernels(state)
        if kernels is not None:
            return self.fused_step(state, kernels, nbr_cache, presorted)
        before = state
        fx, fy, state = self.calc_forces(state, nbr_cache,
                                         presorted=presorted)
        new = self.dynamics(state, fx, fy, t_host)
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
                  overflow=0.0, t0=None) -> AgentState:
        """The `k` steps of one rebuild chunk on the chunk's table
        `cache`, step j's record written to `rows[...][j]`: the program
        `ChunkRunner` captures. `overflow` is the table's overflow count
        for the metrics; `t0` the global step at the chunk's start as the
        caller knows it (any value congruent to it modulo
        `clock_period()`), or None. Nothing here reads a value back to the
        host or has a shape that depends on the data."""
        for j in range(k):
            state, fx, fy = self.step_with_forces(
                state, cache, presorted, None if t0 is None else t0 + j)
            self._record(mode, rows, j, state, fx, fy, overflow)
        return state

    def _run_steps(self, state, steps: int, mode, rows, t0: int,
                   t_host=None, probe=None):
        """`steps` steps that each build their own table (or the dense
        stage), recorded from row `t0` on; `t_host` the global step at
        the first (or None)."""
        for j in range(steps):
            cache, overflow = None, 0.0
            if self.neighbors is not None:
                cache = self._rebuild(state, 1, probe)
                overflow = cache[3].sum()
            state, fx, fy = self.step_with_forces(
                state, cache, t_host=None if t_host is None else t_host + j)
            self._record(mode, rows, t0 + j, state, fx, fy, overflow)
        return state

    def _chunk_runner(self, runner_cls, state, cache, k, presorted, mode,
                      phase=None, probe=None):
        """This engine's `runner_cls` for the program that these
        arguments fix, built (and captured) at first use."""
        key = (presorted, mode, k, phase, state.device,
               tuple((tuple(t.shape), t.dtype) for t in
                     (getattr(state, f) for f in _STATE_FIELDS)),
               tuple(tuple(c.shape) for c in cache))
        if key not in self._runners:
            with tracing.span(probe, "capture", stream=False):
                self._runners[key] = runner_cls(self, state, cache, k,
                                                presorted, mode, phase)
            tracing.count(probe, "captures", 1)
        return self._runners[key]

    def _rebuild(self, state, steps: int, probe):
        """The neighbor table for the next `steps` steps, counted where
        `probe` records: the rebuild, the pairs its valid slots hand the
        pair kernel over those steps, its overflowed rows."""
        with tracing.span(probe, "rebuild"):
            cache = self.neighbor_cache(state)
        cfg = self.neighbors
        tracing.count(probe, "rebuilds", 1)
        tracing.count(probe, "table_pairs", cache[4],
                      cfg.block * cfg.block_src * steps)
        tracing.count(probe, "table_overflow_rows", cache[3])
        return cache

    def graph_launches(self, kernels=PF.KERNELS) -> tuple:
        """Launches of each of `kernels` (the pair kernels, or
        `ops.agent_step.KERNELS`) made by the replays of this engine's
        captured chunks so far, in their order. The wrappers' own counters
        do not see them: a replay runs no wrapper."""
        per_runner = [r.launches(kernels) for r in self._runners.values()]
        return tuple(map(sum, zip(*per_runner))) or (0,) * len(kernels)

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
        probe = tracing.probe(state.device)
        tracing.count(probe, "steps", n_steps)
        with tracing.span(probe, "simulate", stream=False), \
                tracing.growth(probe, "field_pairs",
                               self.field_pairs(state.device)):
            return self._simulate(state, n_steps, mode,
                                  not record and not record_forces,
                                  ChunkRunner if graph else None, probe)

    def _simulate(self, state, n_steps, mode, sorted_resident, runner_cls,
                  probe=None):
        """`simulate` in record mode `mode` (`record_buffers`), on the
        sorted-resident path where `sorted_resident` and the engine's
        class allow it and N is a multiple of the block; the chunks through this engine's
        `runner_cls` (`ChunkRunner`), or with None as eager loops. `probe`
        (`tracing.probe`) records its phases."""
        k = self.neighbors.rebuild_every if self.neighbors is not None else 1
        rows = record_buffers(mode, n_steps, state)
        # a step that reads the global step clock on the host (a
        # resampling cadence) learns it here, once per call
        period = self.clock_period()
        t_host = int(state.t_glob) if period > 1 else None
        if k <= 1 or n_steps < k:
            state = self._run_steps(state, n_steps, mode, rows, 0, t_host,
                                    probe)
            return state, self._records(mode, rows)

        n_chunks, rem = divmod(n_steps, k)
        presorted = (sorted_resident and self.sorted_resident
                     and self.pair_family != "custom"
                     and state.n % self.neighbors.block == 0)
        ident = torch.arange(state.n, device=state.device)
        for c in range(n_chunks):
            cache = self._rebuild(state, k, probe)
            if presorted:
                with tracing.span(probe, "permute"):
                    state = permute_state(state, cache[0])
                    ident = ident[cache[0]]
            chunk_rows = tuple(r[c * k:(c + 1) * k] for r in rows)
            t_chunk = None if t_host is None else t_host + c * k
            if runner_cls is not None:
                runner = self._chunk_runner(
                    runner_cls, state, cache, k, presorted, mode,
                    None if t_chunk is None else t_chunk % period, probe)
                state, static_rows = runner.run(state, cache, probe)
                if chunk_rows:
                    with tracing.span(probe, "copy_out"):
                        for dst, src in zip(chunk_rows, static_rows):
                            dst.copy_(src)
            else:
                with tracing.span(probe, "replay"):
                    state = self.run_chunk(
                        state, cache, k, presorted, mode, chunk_rows,
                        cache[3].sum() if mode == "metrics" else 0.0,
                        t0=t_chunk)
        if runner_cls is not None:
            # the runner's output state is overwritten by its next run
            with tracing.span(probe, "copy_out"):
                state = _map_state(torch.clone, state)
        if presorted:
            with tracing.span(probe, "unpermute"):
                state = permute_state(state, torch.argsort(ident))
        state = self._run_steps(
            state, rem, mode, rows, n_chunks * k,
            None if t_host is None else t_host + n_chunks * k, probe)
        return state, self._records(mode, rows)

    @staticmethod
    def _records(mode, rows):
        if mode is None:
            return None
        return tuple(rows) if mode == "forces" else rows[0]
