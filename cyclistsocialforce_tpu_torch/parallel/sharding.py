"""Agent-axis sharding: one crowd split over a 1-D mesh of shards.

Counterpart of `cyclistsocialforce_tpu.parallel.sharding`, which runs one
step under `shard_map` over a device mesh. Here a `Mesh` names
`n_shards` shards, the ones this process holds, their device, and an
optional `torch.distributed` process group. A sharded state is the list
of this process's shards (one `AgentState` each, in global order): every
per-agent field split on its leading axis, the master key and the global
step clock replicated (`state_pspecs`).

The step is written once and runs in lockstep over the local shards: the
destination force, the dynamics and the bookkeeping are local to a shard;
the pair stage exchanges source rows through the mesh's collectives, each
of which takes the list of the local shards' tensors:

  all_gather  every shard's rows end to end (`dist.all_gather` across
              processes);
  ppermute    shard d's tensor to shard d + shift (only the boundary
              shards cross between processes, by `batch_isend_irecv`);
  pmax        the max over every shard (`all_reduce(MAX)` across
              processes).

So one process holding D shards on one card is the counterpart of JAX's
virtual devices, Gloo processes on the CPU that of its multi-process dry
run (`parallel.dryrun`), NCCL ranks that of a multi-GPU node.

Schedules (`comm=`):

  "allgather"  one all_gather of the sources per step, then the receivers'
               tiles against all of them;
  "ring"       the source block circulates for D hops, one tile (dense)
               or the hop's part of the neighbor table (culled) per hop;
  "halo"       (culled, `sharded_simulate_fn` only) the population
               re-distributed into globally cell-sorted strips once per
               rebuild chunk, then only the `halo` boundary source blocks
               exchanged with the ring neighbors per step.

With a `NeighborConfig` the pair stage is culled and goes through the
engine's pair kernel (`Engine.pair_kernel_dispatch`: K1, K2 or K3 by the
backend on CUDA tensors, the kernel's plain version on CPU tensors). The
CUDA kernels read the first `count` slots of each table row, so the valid
entries of a row must form a prefix: a table masked to a ring hop's
resident blocks, or to a halo window that overflowed, has holes, and is
compacted first (`compact_table`). Self-exclusion is positional (a pair
at distance 0 is not tracked), so the kernels take no receiver offset.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from cyclistsocialforce_tpu_torch import engine as eng
from cyclistsocialforce_tpu_torch import tracing
from cyclistsocialforce_tpu_torch.engine import Engine, permute_state
from cyclistsocialforce_tpu_torch.ops import forces as F
from cyclistsocialforce_tpu_torch.ops import neighbors as NB
from cyclistsocialforce_tpu_torch.ops import random as rnd
from cyclistsocialforce_tpu_torch.state import X, Y, AgentState

AGENT_AXIS = "agents"
# split over the shards on their leading axis; the rest is replicated
SHARDED_FIELDS = eng._ALL_AGENT_FIELDS
REPLICATED_FIELDS = ("t_glob", "key")


class Mesh:
    """A 1-D mesh of `n_shards` agent shards (`make_mesh`).

    shards : the global indices of the shards this process holds, in
        order (rank r of a process group holds n_shards / world of them,
        from r * n_shards / world on).
    device : where this process's shards live.
    group : the `torch.distributed` process group that spans the
        processes, or None when one process holds every shard.

    With a group, all_gather and pmax go through it whatever its size;
    ppermute sends only between processes, so a group of one process
    takes no part in it.

    Set `timing` to a list to time the collectives: each appends its
    `tracing.Span`; `collective_seconds()` sums them."""

    def __init__(self, n_shards: int, shards, device, group=None,
                 axis: str = AGENT_AXIS):
        self.n_shards = int(n_shards)
        self.shards = tuple(int(d) for d in shards)
        self.device = torch.device(device)
        self.group = group
        self.axis = axis
        self.timing = None

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @contextlib.contextmanager
    def _timed(self):
        """Time one collective as the span `csf::collective`: into
        `timing` where it is a list, and into the recorder where
        `tracing` records."""
        probe = tracing.probe(self.device)
        if probe is None and self.timing is None:
            yield
            return
        span = (probe.span("collective") if probe is not None else
                tracing.Span(tracing.PREFIX + "collective",
                             tracing.current_stream(self.device)))
        with span:
            yield
        if self.timing is not None:
            self.timing.append(span)

    def collective_seconds(self) -> float:
        """The seconds the timed collectives took (on a card the stream
        time from each one's start to its end, else the host's)."""
        return sum(span.seconds() for span in self.timing or ())

    def _check(self, parts):
        if len(parts) != len(self.shards):
            raise ValueError(f"{len(parts)} tensors for the "
                             f"{len(self.shards)} local shards")

    def all_gather(self, parts, dim: int = 0) -> torch.Tensor:
        """Every shard's tensor end to end along `dim`, in shard order;
        the same tensor for every local shard."""
        self._check(parts)
        with self._timed():
            local = torch.cat(list(parts), dim=dim) if len(parts) > 1 \
                else parts[0]
            if self.group is None:
                return local
            wire = _wire(local.movedim(dim, 0))
            out = [torch.empty_like(wire) for _ in range(self.world)]
            dist.all_gather(out, wire, group=self.group)
            return _unwire(torch.cat(out), local.dtype).movedim(0, dim)

    def ppermute(self, parts, shift: int = 1) -> list:
        """Shard d's tensor moved to shard (d + shift) mod n_shards, shift
        +1 or -1: out[j] is the tensor of the shard before (+1) or after
        (-1) local shard j."""
        self._check(parts)
        if shift not in (1, -1):
            raise ValueError(f"shift must be +1 or -1, got {shift}")
        with self._timed():
            if shift == 1:
                out, boundary, slot = [None] + list(parts[:-1]), parts[-1], 0
            else:
                out, boundary, slot = list(parts[1:]) + [None], parts[0], -1
            if self.world == 1:
                out[slot] = boundary
                return out
            wire = _wire(boundary)
            got = torch.empty_like(wire)
            ops = [dist.P2POp(dist.isend, wire,
                              (self.rank + shift) % self.world, self.group),
                   dist.P2POp(dist.irecv, got,
                              (self.rank - shift) % self.world, self.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            out[slot] = _unwire(got, boundary.dtype)
            return out

    def pmax(self, parts) -> torch.Tensor:
        """The max over every shard's 0-d tensor (a bool's: any)."""
        self._check(parts)
        with self._timed():
            dtype = parts[0].dtype
            m = torch.stack([p.reshape(()).to(torch.int32)
                             if dtype == torch.bool else p.reshape(())
                             for p in parts]).amax()
            if self.group is not None:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
            return m.bool() if dtype == torch.bool else m


def _wire(t):
    """`t` as the collectives carry it: contiguous, bool as uint8."""
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def _unwire(t, dtype):
    return t.bool() if dtype == torch.bool else t


def make_mesh(n_devices: int | None = None, axis: str = AGENT_AXIS,
              group=None, device="cuda") -> Mesh:
    """A 1-D mesh of `n_devices` shards over the agent axis (None: one
    per process of `group`, one without). Without a group this process
    holds every shard on `device`; with one, each process holds
    n_devices / world consecutive shards. A group that spans processes on
    CUDA devices is NCCL's, on the CPU Gloo's."""
    world = 1 if group is None else dist.get_world_size(group)
    n = world if n_devices is None else int(n_devices)
    if n < 1 or n % world:
        raise ValueError(f"{n} shards do not divide over {world} "
                         f"process(es)")
    device = torch.device(device)
    if group is not None:
        backend = str(dist.get_backend(group)).lower()
        want = "nccl" if device.type == "cuda" else "gloo"
        if backend != want:
            raise ValueError(f"a process group over {device.type} shards "
                             f"is {want}'s, this one is {backend}'s")
    k = n // world
    rank = 0 if group is None else dist.get_rank(group)
    return Mesh(n, range(rank * k, (rank + 1) * k), device, group, axis)


def state_pspecs(axis: str = AGENT_AXIS) -> AgentState:
    """Which AgentState fields are sharded: `axis` for each per-agent
    field (split on its leading axis), None for the replicated master key
    and global step clock."""
    specs = {f: axis for f in SHARDED_FIELDS}
    specs.update({f: None for f in REPLICATED_FIELDS})
    return AgentState(**specs)


def shard_state(state: AgentState, mesh: Mesh,
                axis: str = AGENT_AXIS) -> list:
    """This process's shards of `state` on the mesh's device: a list of
    AgentState, one per local shard (N must divide by n_shards)."""
    n = state.n
    if n % mesh.n_shards:
        raise ValueError(f"{n} agents do not divide into "
                         f"{mesh.n_shards} shards")
    nl = n // mesh.n_shards
    specs = state_pspecs(axis)
    out = []
    for d in mesh.shards:
        fields = {}
        for f in dataclasses.fields(AgentState):
            v = getattr(state, f.name)
            if getattr(specs, f.name) is not None:
                v = v[d * nl:(d + 1) * nl]
            fields[f.name] = v.to(mesh.device).clone()
        out.append(AgentState(**fields))
    return out


def gather_state(shards, mesh: Mesh) -> AgentState:
    """The global state from the shards (every process's, through the
    mesh's all_gather): the counterpart of reading a global jax.Array."""
    st = shards[0]
    return st.replace(**{f: mesh.all_gather([getattr(s, f) for s in shards])
                         for f in SHARDED_FIELDS})


def compact_table(nbr, mask):
    """(nbr, mask, count) with each row's valid entries moved to the
    front in their slot order (a stable sort on ~mask), and count [B]
    int32 the valid entries per row: the form the CUDA kernels read. The
    plain version adds the slots' sums in slot order, so it gives the
    same forces bit for bit from either form."""
    order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
    return (torch.gather(nbr, 1, order).contiguous(),
            torch.gather(mask, 1, order).contiguous(),
            mask.sum(dim=1, dtype=torch.int32))


def _params_by_uid(params, uid, lo: int = 0):
    """`params` as a shard's rows see them: each per-agent tensor (a
    tensor leaf with a leading agent axis, as `as_population` makes it;
    the leaf's type decides, not its shape) taken at row uid - lo,
    clamped to the table; shared leaves as they are."""
    upd = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            off = torch.clamp(uid.long() - lo, 0, v.shape[0] - 1)
            upd[f.name] = v.to(uid.device)[off]
    return dataclasses.replace(params, **upd) if upd else params


def _hfov_rows(engine, lstate):
    """The shard's rows' hfov: a shared value broadcast; a per-agent
    table indexed by the rows' uid."""
    hfov = engine.params.hfov
    s = lstate.s
    if isinstance(hfov, torch.Tensor) and hfov.ndim >= 1:
        return hfov.to(dtype=s.dtype, device=s.device)[lstate.uid.long()]
    return torch.full((lstate.n,), float(hfov), dtype=s.dtype,
                      device=s.device)


# ---- the dense pair stage ----


def _repulsive_allgather(engine, mesh, lstates):
    """All-gather schedule: every shard's receivers against every
    source."""
    nl = lstates[0].n
    bundles = [engine._src_bundle(st) for st in lstates]
    src = tuple(mesh.all_gather([b[i] for b in bundles]) for i in range(4))
    active_src = mesh.all_gather([st.active for st in lstates])
    hfov_src = mesh.all_gather([_hfov_rows(engine, st) for st in lstates])
    idx_src = torch.arange(nl * mesh.n_shards, device=mesh.device)
    return [engine.repulsive_sum(st, src=src, idx_src=idx_src,
                                 active_src=active_src, hfov_src=hfov_src,
                                 recv_offset=d * nl)
            for d, st in zip(mesh.shards, lstates)]


def _repulsive_ring(engine, mesh, lstates):
    """Ring schedule: the source block circulates for D hops, one [N/D,
    N/D] tile per hop, its sum added to the receivers' (the source sum
    re-associated per hop)."""
    if engine.rep_reduce is not None:
        raise ValueError("the ring schedule accumulates partial SUMS per "
                         "hop; custom rep_reduce hooks need 'allgather'")
    nl = lstates[0].n
    size = mesh.n_shards
    lane = torch.arange(nl, device=mesh.device)
    blocks = [(*engine._src_bundle(st), st.active, _hfov_rows(engine, st))
              for st in lstates]
    acc = [(torch.zeros_like(st.s[:, X]), torch.zeros_like(st.s[:, X]))
           for st in lstates]
    for hop in range(size):
        for j, (d, st) in enumerate(zip(mesh.shards, lstates)):
            xs, ys, psis, vs, act_s, hfov_s = blocks[j]
            recv = engine._src_bundle(st)
            fpx, fpy = engine.rep_force(engine.params, (xs, ys, psis, vs),
                                        recv)
            untracked = F.untracked_foes_tile(
                xs, ys, ((d - hop) % size) * nl + lane, act_s, hfov_s,
                recv[0], recv[1], recv[2], d * nl + lane, st.active,
                priority_p2r=engine.priority_p2r)
            dx, dy = F.sum_sources(fpx, fpy, ~untracked)
            acc[j] = (acc[j][0] + dx, acc[j][1] + dy)
        if hop < size - 1:
            blocks = list(zip(*(mesh.ppermute(list(col), 1)
                                for col in zip(*blocks))))
    return acc


_REP_COMMS = {"allgather": _repulsive_allgather, "ring": _repulsive_ring}


# ---- the culled pair stage: local receivers, gathered sources ----


def _neighbor_cache_sharded(engine, mesh, lstates):
    """Each shard's culling structure against the GLOBAL source blocks:
    a local cell sort into `block`-agent blocks, every shard's source
    block boxes all-gathered (a few floats a block), and the local
    receivers' table indexing the global source blocks (shard d's at
    [d * B_src, (d + 1) * B_src)). Per shard (perm, nbr, valid,
    overflow, count)."""
    cfg = engine.neighbors
    nl = lstates[0].n
    blk = cfg.block
    npad = -(-nl // blk) * blk
    cut = cfg.cutoff + cfg.skin
    perms, boxes, src_boxes = [], [], []
    for st in lstates:
        x, y = st.s[:, X], st.s[:, Y]
        if npad != nl:
            x = torch.cat([x, x[:1].expand(npad - nl)])
            y = torch.cat([y, y[:1].expand(npad - nl)])
        perm = NB.sort_by_cell(x, y, cut)
        xs, ys = x[perm], y[perm]
        b = NB.block_bboxes(xs, ys, blk)
        perms.append(perm)
        boxes.append(b)
        src_boxes.append(b if cfg.block_src == blk
                         else NB.block_bboxes(xs, ys, cfg.block_src))
    boxes_glob = mesh.all_gather(src_boxes)
    caches = []
    for perm, b in zip(perms, boxes):
        nbr, valid, overflow = NB.neighbor_block_table(
            b, cut, cfg.kb, src_bboxes=boxes_glob, chunk=cfg.table_chunk)
        caches.append((perm, nbr, valid, overflow,
                       valid.sum(dim=1, dtype=torch.int32)))
    return caches


def hop_table(cache, lo: int, bl_src: int):
    """A ring hop's table: the entries of `cache`'s table (a
    `_neighbor_cache_sharded` entry) that index the resident shard's
    source blocks [lo, lo + bl_src), re-indexed into its pack and
    compacted (`compact_table`)."""
    nbr, valid = cache[1], cache[2]
    in_hop = valid & (nbr >= lo) & (nbr < lo + bl_src)
    return compact_table(torch.where(in_hop, nbr - lo, 0), in_hop)


def _repulsive_neighbors(engine, mesh, lstates, caches=None,
                         presorted=False, comm="allgather"):
    """Culled sharded pair forces: each shard's packs cell-sorted, the
    sorted source packs exchanged, only the table's tiles evaluated
    against the local receivers.

    comm="allgather": one [N, 16] all_gather per step.
    comm="ring": the [N/D, 16] sorted pack circulates for D hops; each
    hop masks the table down to the entries of the resident shard's
    blocks and compacts it (`compact_table`), so the kernel evaluates
    only the hop's in-cutoff tiles. With presorted=True the shards' rows
    are already in their cache's cell-sorted order (the sorted-resident
    chunks): no pack gather, no force scatter."""
    cfg = engine.neighbors
    nl = lstates[0].n
    npad = -(-nl // cfg.block) * cfg.block
    size = mesh.n_shards
    bl_src = npad // cfg.block_src
    if caches is None:
        caches = _neighbor_cache_sharded(engine, mesh, lstates)
    packs = [engine.pack_pair_fields(st, npad) for st in lstates]
    if not presorted:
        packs = [eng.sorted_packs(p[0], c[0]) for p, c in zip(packs, caches)]
    if comm == "ring":
        blocks = [p[0] for p in packs]
        outs = [torch.zeros((2, npad), dtype=st.s.dtype, device=st.device)
                for st in lstates]
        for hop in range(size):
            for j, d in enumerate(mesh.shards):
                nbr_h, in_hop, count = hop_table(
                    caches[j], ((d - hop) % size) * bl_src, bl_src)
                outs[j] = outs[j] + engine.pair_kernel_dispatch(
                    nbr_h, in_hop, blocks[j], packs[j][1], count)
            if hop < size - 1:
                blocks = mesh.ppermute(blocks, 1)
    else:
        src_glob = mesh.all_gather([p[0] for p in packs])
        outs = [engine.pair_kernel_dispatch(c[1], c[2], src_glob, p[1],
                                            c[4])
                for c, p in zip(caches, packs)]
    if presorted:
        return [(o[0, :nl], o[1, :nl]) for o in outs]
    return [eng.unsort_forces(o, c[0], nl) for o, c in zip(outs, caches)]


# ---- the halo schedule: globally sorted strips, boundary exchange ----


def _reshard_rows(mesh, lstates, idents, idxs):
    """Global rows `idxs[j]` (local shard j's slice of a global
    permutation, the same on every process) fetched into the local
    shards: every per-agent field, and the carried original-row identity
    `idents`, gathered and taken by rows."""
    taken = [{} for _ in lstates]
    for f in SHARDED_FIELDS:
        g = mesh.all_gather([getattr(st, f) for st in lstates])
        for t, idx in zip(taken, idxs):
            t[f] = g[idx]
    ident_g = mesh.all_gather(idents)
    return ([st.replace(**t) for st, t in zip(lstates, taken)],
            [ident_g[idx] for idx in idxs])


def _global_reshard(engine, mesh, lstates, idents, from_original=False):
    """Re-distribute the agents into globally cell-sorted strips: every
    process computes the same global serpentine cell sort from the
    gathered positions, then each shard takes its strip's rows, so shard
    d holds global sort positions [d * n_l, (d + 1) * n_l) and its
    in-cutoff source blocks live on d and its ring neighbors.

    from_original=True sorts with the agents arranged in their ORIGINAL
    row order (through the carried identity): a sort's ties follow the
    input order, and the table's truncation is tie-sensitive, so this is
    what keeps the schedule equal to `Engine.simulate`'s chunks of an
    engine that is not sorted-resident (each sorts from original order);
    a sorted-resident engine sorts from the previous chunk's order, as
    `simulate`'s sorted-resident chunks do."""
    cfg = engine.neighbors
    nl = lstates[0].n
    cut = cfg.cutoff + cfg.skin
    x_g = mesh.all_gather([st.s[:, X] for st in lstates])
    y_g = mesh.all_gather([st.s[:, Y] for st in lstates])
    if from_original:
        inv = torch.argsort(mesh.all_gather(idents))
        perm = inv[NB.sort_by_cell(x_g[inv], y_g[inv], cut)]
    else:
        perm = NB.sort_by_cell(x_g, y_g, cut)
    idxs = [perm[d * nl:(d + 1) * nl] for d in mesh.shards]
    return _reshard_rows(mesh, lstates, idents, idxs)


def _neighbor_cache_halo(engine, mesh, lstates, halo):
    """Each strip's table (built against the gathered GLOBAL source-block
    boxes) re-indexed into its halo window [d * B_src - halo, (d + 1) *
    B_src + halo) and compacted. Entries outside the window are dropped
    and flagged: per shard (nbr, valid, halo_overflow, count), the flag
    True when `halo` is too small for the geometry or the table
    overflows kb (see `required_halo`)."""
    cfg = engine.neighbors
    nl = lstates[0].n
    cut = cfg.cutoff + cfg.skin
    boxes, src_boxes = [], []
    for st in lstates:
        xs, ys = st.s[:, X], st.s[:, Y]          # already globally sorted
        b = NB.block_bboxes(xs, ys, cfg.block)
        boxes.append(b)
        src_boxes.append(b if cfg.block_src == cfg.block
                         else NB.block_bboxes(xs, ys, cfg.block_src))
    boxes_glob = mesh.all_gather(src_boxes)
    bl_src = nl // cfg.block_src
    caches = []
    for d, b in zip(mesh.shards, boxes):
        nbr, valid, overflow = NB.neighbor_block_table(
            b, cut, cfg.kb, src_bboxes=boxes_glob, chunk=cfg.table_chunk)
        lo_win = d * bl_src - halo
        win = valid & (nbr >= lo_win) & (nbr < lo_win + bl_src + 2 * halo)
        halo_overflow = torch.any(valid & ~win) | torch.any(overflow)
        nbr_ext, win, count = compact_table(
            torch.where(win, nbr - lo_win, 0), win)
        caches.append((nbr_ext, win, halo_overflow, count))
    return caches


def _repulsive_neighbors_halo(engine, mesh, lstates, caches, halo):
    """A step's culled pair stage on globally sorted strips: each shard
    evaluates its windowed table against its halo window's sources
    (`halo_packs`)."""
    nl = lstates[0].n
    outs = []
    for (src_ext, recv), c in zip(halo_packs(engine, mesh, lstates, halo),
                                  caches):
        out = engine.pair_kernel_dispatch(c[0], c[1], src_ext, recv, c[3])
        outs.append((out[0, :nl], out[1, :nl]))
    return outs


def halo_packs(engine, mesh, lstates, halo):
    """Per shard (source pack of its halo window, receiver pack): its own
    sorted pack with the `halo` boundary source blocks of each ring
    neighbor on either side (two ppermutes of [halo * block_src, 16]
    rows)."""
    nl = lstates[0].n
    packs = [engine.pack_pair_fields(st, nl) for st in lstates]
    hr = halo * engine.neighbors.block_src
    left = mesh.ppermute([p[0][nl - hr:] for p in packs], 1)
    right = mesh.ppermute([p[0][:hr] for p in packs], -1)
    return [(torch.cat([left[j], src, right[j]]), recv)
            for j, (src, recv) in enumerate(packs)]


def required_halo(engine: Engine, state: AgentState, n_devices: int) -> int:
    """The smallest `halo` (SOURCE blocks per side) the halo schedule
    needs for `state` split over `n_devices` strips: the global sort and
    table built on the CPU, and the farthest valid entry outside each
    receiver's own strip measured. Audit it at t = 0 and after a run
    (positions drift; each chunk's rebuild re-sorts)."""
    cfg = engine.neighbors
    n = state.n
    if n % n_devices or (n // n_devices) % cfg.block:
        raise ValueError("halo schedule needs n divisible by the mesh "
                         "size and local shards divisible by block")
    nl = n // n_devices
    cut = cfg.cutoff + cfg.skin
    x = state.s[:, X].detach().cpu()
    y = state.s[:, Y].detach().cpu()
    perm = NB.sort_by_cell(x, y, cut)
    xs, ys = x[perm], y[perm]
    boxes = NB.block_bboxes(xs, ys, cfg.block)
    src_boxes = (boxes if cfg.block_src == cfg.block
                 else NB.block_bboxes(xs, ys, cfg.block_src))
    nbr, valid, _ = NB.neighbor_block_table(
        boxes, cut, cfg.kb, src_bboxes=src_boxes, chunk=cfg.table_chunk)
    bl = nl // cfg.block
    bl_src = nl // cfg.block_src
    lo = ((torch.arange(nbr.shape[0]) // bl) * bl_src)[:, None]
    excess = torch.maximum(lo - nbr, nbr - (lo + bl_src - 1))
    return int(torch.where(valid, excess, 0).max())


def _check_sharded_support(engine, comm):
    # scripted agents are supported: their tables are indexed by the
    # persistent uid, which names a shard's rows globally
    if engine.rep_reduce is not None and (comm == "ring"
                                          or engine.neighbors is not None):
        raise ValueError("custom rep_reduce hooks accumulate partial sums "
                         "per hop/tile; only comm='allgather' without "
                         "neighbor culling supports them sharded")
    if engine.neighbors is not None and engine.pair_family == "custom":
        raise ValueError("custom force tiles support neighbor culling "
                         "only single-device (the generic per-receiver-"
                         "block path); use the dense comm schedules "
                         "sharded")


def _local_step(engine, mesh, rep_comm, lstates, nbr_cache=None,
                presorted=False, comm="allgather", halo=0, t_host=None):
    """One sharded step of every local shard, in lockstep: per shard
    (state, fx, fy). `Engine.step_with_forces`'s stages, with the pair
    stage over the mesh; a shard's rows read per-agent parameters by
    uid."""
    for st in lstates:
        engine.check_state(st)
    params = [_params_by_uid(engine.params, st.uid) for st in lstates]
    dest, sts = [], []
    for p, st in zip(params, lstates):
        fdx, fdy, st = engine.destination_forces(st, p)
        dest.append(engine.mask_scripted(st, fdx, fdy))
        sts.append(st)
    rep = _pair_stage(engine, mesh, sts, nbr_cache, presorted, comm, halo,
                      rep_comm)
    out = []
    for before, p, st, (fdx, fdy), r in zip(lstates, params, sts, dest,
                                             rep):
        fx, fy = engine.add_pair_and_road(st, fdx, fdy, r)
        new = engine.dynamics(st, fx, fy, t_host, p)
        out.append((engine.finish_step(before, new), fx, fy))
    return out


def _pair_stage(engine, mesh, sts, nbr_cache, presorted, comm, halo,
                rep_comm=None):
    """Per shard the pair stage's (frx, fry) under `comm`, or None
    where the engine has none."""
    if engine.pair_family is None or mesh.n_shards * sts[0].n <= 1:
        return [None] * len(sts)
    if engine.neighbors is not None and comm == "halo":
        return _repulsive_neighbors_halo(engine, mesh, sts, nbr_cache, halo)
    if engine.neighbors is not None:
        return _repulsive_neighbors(engine, mesh, sts, nbr_cache,
                                    presorted=presorted, comm=comm)
    return rep_comm(engine, mesh, sts)


# ---- heterogeneous (MixedEngine) populations: group membership rides
# the uid; each group's destination force and dynamics run masked over
# the whole shard, the pair stage once through the mixed-family form ----


def _is_mixed(engine):
    from cyclistsocialforce_tpu_torch.mixed import MixedEngine
    return isinstance(engine, MixedEngine)


def _group_params_local(g, lstate):
    """Group `g`'s parameters as the shard's rows see them: per-agent
    tensors (in group row order) at row uid - lo, clamped, so rows
    outside the group read a finite value whose results are discarded;
    the leaf's type decides what is per agent."""
    return _params_by_uid(g.params, lstate.uid, g.lo)


def _masked_merge_rows(old_state, new_state, m):
    """Rows where `m` take `new_state`'s per-agent fields (the sharded
    counterpart of mixed.state_merge)."""
    def pick(f):
        ol, nw = getattr(old_state, f), getattr(new_state, f)
        mm = m.reshape(m.shape + (1,) * (ol.ndim - 1))
        return torch.where(mm, nw.to(ol.dtype), ol)

    return old_state.replace(**{f: pick(f) for f in SHARDED_FIELDS})


def _mixed_local_step(me, mesh, lstates, nbr_cache=None, presorted=False,
                      comm="allgather", halo=0, t_host=None):
    """One sharded MixedEngine step of every local shard: each group's
    stages masked over the whole shard (a shard's rows span group
    boundaries); per row the same results as `MixedEngine.step`, every
    group stage being elementwise in the row and the draws keyed by the
    master key folded with the group index, t_glob and the uid."""
    for st in lstates:
        for g in me.groups:
            eng._check_state_widths(getattr(g.model, "STATE_WIDTHS", None),
                                    st)
    dest, sts, masks = [], [], []
    for st in lstates:
        m = me.group_masks(st)
        dtype = st.s.dtype
        fdx = torch.zeros((st.n,), dtype=dtype, device=st.device)
        fdy = torch.zeros_like(fdx)
        cur = st
        for g, mg in zip(me.groups, m):
            gfx, gfy, new = g.dest_force(_group_params_local(g, st), st,
                                         **g.dest_kw)
            fdx = torch.where(mg, gfx.to(dtype), fdx)
            fdy = torch.where(mg, gfy.to(dtype), fdy)
            cur = _masked_merge_rows(cur, new, mg)
        dest.append(me.mask_scripted(cur, fdx, fdy))
        sts.append(cur)
        masks.append(m)
    rep = _pair_stage(me, mesh, sts, nbr_cache, presorted, comm, halo)
    out = []
    for before, st, m, (fdx, fdy), r in zip(lstates, sts, masks, dest, rep):
        fx, fy = me.add_pair_and_road(st, fdx, fdy, r)
        cur = st
        for gi, (g, mg) in enumerate(zip(me.groups, m)):
            sub = st
            if (getattr(g.params, "stochastic_control_behavior", False)
                    or getattr(g.params, "br_disturb", False)):
                sub = st.replace(key=rnd.fold_in(st.key, gi))
            cand = g.model.step(
                _group_params_local(g, st), sub, fx, fy,
                **me.kept_constants(getattr(g.model, "step_constants",
                                            None), g.params, st, gi),
                **me._clock_kw(getattr(g.model, "clock_period", None),
                               g.params, t_host))
            cur = _masked_merge_rows(cur, cand, mg)
        out.append((me.finish_step(before, cur), fx, fy))
    return out


def _check_sharded_support_mixed(me, comm):
    if me.neighbors is None:
        raise ValueError(
            "sharded MixedEngine requires neighbor culling "
            "(MixedEngine.create(..., neighbors=NeighborConfig(...))): "
            "the dense mixed pair stage materializes [N, N] per family "
            "and has no sharded schedule")
    for g in me.groups:
        if getattr(g.params, "br_resample_budget", 0):
            raise ValueError(
                "stochastic groups under a sharded MixedEngine need "
                "resample_budget=0 (unlimited): the budget compaction "
                "is population-order-dependent and the masked whole-"
                "shard evaluation would spend budget on foreign rows")


def _step_impl(engine, comm):
    """The checked local step of `engine` under `comm`: a function of
    (mesh, shards, **options)."""
    if _is_mixed(engine):
        _check_sharded_support_mixed(engine, comm)
        return lambda mesh, lstates, **kw: _mixed_local_step(
            engine, mesh, lstates, **kw)
    _check_sharded_support(engine, comm)
    rep_comm = _REP_COMMS.get(comm)
    return lambda mesh, lstates, **kw: _local_step(
        engine, mesh, rep_comm, lstates, **kw)


def _host_clock(engine, lstates):
    """The global step as the host knows it, for a model whose step reads
    the clock on the host (a resampling cadence); else None."""
    if engine.clock_period() > 1:
        return int(lstates[0].t_glob)
    return None


def _check_comm(comm, allowed):
    if comm not in allowed:
        raise ValueError(f"comm must be one of {allowed}, got {comm!r}")


def sharded_step_fn(engine: Engine, mesh: Mesh, axis: str = AGENT_AXIS,
                    with_forces: bool = False, comm: str = "allgather"):
    """A one-step function over the mesh: `step(shards)` -> the shards
    after one step (with_forces: and the lists of per-shard fx, fy).

    N must divide by the mesh size. In the DENSE schedules the pair
    field's parameters must be shared (the tiles read them per source);
    per-agent destination and dynamics parameters are read by uid, and
    per-agent hfov tables too. The CULLED path (`engine.neighbors`) takes
    per-agent pair parameters (the pack reads them by uid). Scripted
    agents work everywhere (uid-indexed tables). A `MixedEngine` needs
    neighbor culling and runs each group's stages masked by uid."""
    if comm == "halo":
        raise ValueError(
            "comm='halo' amortizes its global reshard over a rebuild "
            "chunk, so it only exists for sharded_simulate_fn; a "
            "single sharded step has no chunk to amortize over")
    _check_comm(comm, tuple(_REP_COMMS))
    impl = _step_impl(engine, comm)

    def step(lstates):
        out = impl(mesh, lstates, comm=comm,
                   t_host=_host_clock(engine, lstates))
        sts = [o[0] for o in out]
        if with_forces:
            return sts, [o[1] for o in out], [o[2] for o in out]
        return sts

    return step


def _sorted_resident_ok(engine, lstate, record):
    """May the shards' rows live in cell-sorted order for whole chunks
    (the counterpart of `Engine.simulate`'s sorted-resident chunks)?"""
    return (engine.sorted_resident and engine.neighbors is not None
            and not record and engine.pair_family != "custom"
            and lstate.n % engine.neighbors.block == 0)


def sharded_simulate_fn(engine: Engine, mesh: Mesh, n_steps: int,
                        axis: str = AGENT_AXIS, record: bool = False,
                        comm: str = "allgather", halo: int = 2):
    """An `n_steps` run over the mesh: `run(shards)` -> (shards, records)
    with records the per-shard [T, n_l, 8] states (record=True) or None.

    With `engine.neighbors` each shard's neighbor structure is rebuilt
    every `rebuild_every` steps (the skin keeps the table conservative in
    between) and the leftover steps rebuild every step, as in
    `Engine.simulate`; without records and with shards divisible by the
    block the rows stay cell-sorted for each whole chunk.

    comm="halo" (culled engines) re-distributes the population into
    GLOBALLY cell-sorted strips once per rebuild chunk and exchanges only
    the `halo` boundary source blocks per step: run(shards) -> (shards,
    halo_overflow), a bool 0-d tensor, True when `halo` or kb is too
    small for the geometry (size it with `required_halo` plus a block).
    Needs record=False and shards divisible by the block; the physics is
    that of the other schedules (the same global table)."""
    if comm == "halo":
        return _sharded_simulate_halo_fn(engine, mesh, n_steps, axis,
                                         record, halo)
    _check_comm(comm, tuple(_REP_COMMS))
    impl = _step_impl(engine, comm)

    def run(lstates):
        t0 = _host_clock(engine, lstates)
        recs = [[] for _ in lstates] if record else None
        t = 0

        def step(sts, **kw):
            nonlocal t
            out = impl(mesh, sts, comm=comm,
                       t_host=None if t0 is None else t0 + t, **kw)
            t += 1
            sts = [o[0] for o in out]
            if record:
                for r, st in zip(recs, sts):
                    r.append(st.s)
            return sts

        def records():
            return [torch.stack(r) for r in recs] if record else None

        sts = list(lstates)
        k = (engine.neighbors.rebuild_every
             if engine.neighbors is not None else 1)
        if k <= 1 or n_steps < k:
            for _ in range(n_steps):
                sts = step(sts)
            return sts, records()
        n_chunks, rem = divmod(n_steps, k)
        sr = _sorted_resident_ok(engine, sts[0], record)
        idents = [torch.arange(st.n, device=st.device) for st in sts]
        for _ in range(n_chunks):
            caches = _neighbor_cache_sharded(engine, mesh, sts)
            if sr:
                sts = [permute_state(st, c[0]) for st, c in zip(sts, caches)]
                idents = [i[c[0]] for i, c in zip(idents, caches)]
            for _ in range(k):
                sts = step(sts, nbr_cache=caches, presorted=sr)
        if sr:
            sts = [permute_state(st, torch.argsort(i))
                   for st, i in zip(sts, idents)]
        for _ in range(rem):
            sts = step(sts)
        return sts, records()

    return run


def _sharded_simulate_halo_fn(engine, mesh, n_steps, axis, record, halo):
    """The comm="halo" run: chunks over globally contiguous strips with
    the per-step boundary exchange, the original distribution restored
    at the end through the identity carry."""
    if engine.neighbors is None:
        raise ValueError("comm='halo' needs a culled engine "
                         "(Engine.create(neighbors=...))")
    if record:
        raise ValueError("comm='halo' keeps rows in globally sorted "
                         "order across rebuild chunks; per-step "
                         "recording is not supported (use comm="
                         "'allgather')")
    impl = _step_impl(engine, "halo")
    if halo < 1:
        raise ValueError("halo must be >= 1 source block per side")
    cfg = engine.neighbors
    k = max(cfg.rebuild_every, 1)
    # an engine that is not sorted-resident keeps its strips all the
    # same (the exchange needs them) but sorts from original row order
    from_original = not engine.sorted_resident

    def run(lstates):
        nl = lstates[0].n
        if nl % cfg.block:
            raise ValueError(
                f"comm='halo' needs local shards divisible by block "
                f"({cfg.block}); got {nl} agents/device")
        if halo * cfg.block_src > nl:
            raise ValueError("halo window wider than a device strip")
        t0 = _host_clock(engine, lstates)
        t = 0
        sts = list(lstates)
        idents = [d * nl + torch.arange(nl, device=st.device)
                  for d, st in zip(mesh.shards, sts)]
        ovf = [torch.zeros((), dtype=torch.bool, device=st.device)
               for st in sts]

        def chunk(sts, idents, ovf, m):
            nonlocal t
            sts, idents = _global_reshard(engine, mesh, sts, idents,
                                          from_original)
            caches = _neighbor_cache_halo(engine, mesh, sts, halo)
            for _ in range(m):
                out = impl(mesh, sts, nbr_cache=caches, comm="halo",
                           halo=halo,
                           t_host=None if t0 is None else t0 + t)
                t += 1
                sts = [o[0] for o in out]
            return sts, idents, [o | c[2] for o, c in zip(ovf, caches)]

        def restore(sts, idents):
            # original id i lives at global row argsort(ident_g)[i]
            rows = torch.argsort(mesh.all_gather(idents))
            return _reshard_rows(mesh, sts, idents,
                                 [rows[d * nl:(d + 1) * nl]
                                  for d in mesh.shards])

        n_chunks, rem = divmod(n_steps, k)
        for _ in range(n_chunks):
            sts, idents, ovf = chunk(sts, idents, ovf, k)
        if n_chunks:
            sts, idents = restore(sts, idents)
        # the leftover steps rebuild every step and return to the
        # original distribution in between: the freshness and the sort's
        # tie order of `Engine.simulate`'s leftover steps
        for _ in range(rem):
            sts, idents, ovf = chunk(sts, idents, ovf, 1)
            sts, idents = restore(sts, idents)
        return sts, mesh.pmax(ovf)

    return run


__all__ = ["AGENT_AXIS", "Mesh", "compact_table", "gather_state",
           "make_mesh", "required_halo", "shard_state",
           "sharded_simulate_fn", "sharded_step_fn", "state_pspecs"]
