"""Block-sparse pairwise repulsive-force sum: the CUDA kernels' wrappers,
their plain PyTorch version, and the kernels' launch counters.

Port of the three Pallas kernels of `cyclistsocialforce_tpu.ops.
pallas_forces`, which share the tile math `_tile_forces`. Agents are
cell-sorted and blocked (`ops.neighbors`); each receiver block sums the
field of the sources in its neighbor-block table: the BMD2023 "twod"
field, or with `mixed=True` each source row's own family, twod or the
legacy v0.1 elliptic field, by its column 13.

  pair_forces_neighbors           K1 `_pair_kernel`, `csrc/pair_forces.cu`:
                                  one source tile at a time, optional
                                  tile or strip distance screen
  pair_forces_neighbors_unrolled  K2 `_pair_kernel_unrolled`,
                                  `csrc/pair_forces_unrolled.cu`: every
                                  tile staged before use, no screen
  pair_forces_neighbors_db        K3 `_pair_kernel_db`,
                                  `csrc/pair_forces_db.cu`: a 4-slot ring
                                  of block-row tiles, the tile screen at
                                  the cutoff, per-source field parameters

Packing layout (built by `engine.Engine.pack_pair_fields`, cell-sorted):
  src_pack  [N_src, 16]: x, y, cos psi, sin psi, f_0 * emit, e_0, e_1,
                         sigma_0..3, cos(hfov/2), emit, family, (unused),
                         receiver activity flag
  recv_pack [8, N]:      x, y, cos psi, sin psi, active, (unused) x 3
The emit flag (active AND amplitude > 0) is folded into column 4, so a
non-emitting source contributes P = 0 with no mask of its own. The family
column (read only with `mixed`) is 0 for a twod row and 1 for a legacy
row, whose columns 4-7 then hold amp * emit (amp = p_0/p_decay), e,
1/sqrt(1 - e^2) and 1/p_decay, and columns 8-10 are unused.

Each wrapper runs its CUDA kernel on CUDA tensors and the plain version,
in the matching form, on CPU tensors; it raises for any other input,
and on CUDA tensors for a receiver `block` the kernels are not compiled
for (they take `KERNEL_BLOCKS`: 64, 128 and 256).
"""

from __future__ import annotations

import torch

SRC_COLS = 16
RECV_ROWS = 8
_SX, _SY, _SC, _SS, _F0, _E0, _E1, _S0, _S1, _S2, _S3, _CHF, _SACT, \
    _FAM = range(14)
_RACT = 15

# half-angle floor m4 >= 4e-12 of the float32 tile (see _tile_forces),
# scaled for wider dtypes by the square of the machine-epsilon ratio so
# that it bounds the same rounding-decoupled case and nothing more
_M4_FLOOR_F32 = 4e-12


def _m4_floor(dtype) -> float:
    ratio = torch.finfo(dtype).eps / torch.finfo(torch.float32).eps
    return _M4_FLOOR_F32 * ratio * ratio


def cutoff_squared(cutoff: float) -> float:
    """The squared cutoff the distance screens compare with, as the JAX
    package computes it (3e38, a finite float32, for an infinite cutoff)."""
    return float(cutoff) ** 2 if cutoff != float("inf") else 3.0e38


def tile_forces(src, xr, yr, cr, sr, act_r, uniform=None, fov=True,
                priority_p2r=False, strip=0, cutoff2=None, mixed=False):
    """Field of sources `src` [..., S, 16] at receivers (xr, yr, cr, sr,
    act_r) [..., 1, R], summed over the sources: (fx, fy) [..., R].

    The algebra of the Pallas tile (`pallas_forces._tile_forces`), in the
    input's dtype: the unit separation vector from one rsqrt, the
    one-rsqrt half-angle form in m4 = |u_rho - u_psi|^2 = 4 sin^2(phi/2),
    which interpolates through the reference's sign(sin phi) jump at
    phi = 0, and the force direction (u, v) rescaled by sigma^2 sqrt(ec2).

    strip > 0 screens the sources in strips of `strip` rows (S a multiple
    of it): a strip contributes nothing when no pair of it and the
    receivers lies within rho2 <= cutoff2, the minimum taken over every
    receiver and source row given, inactive and pad rows included.

    mixed=True selects each source row's family by its column 13, as the
    Pallas tile does: both fields are evaluated for every pair and the
    row's own is kept. On legacy rows the twod branch runs with e = 0,
    sigma = 1 so that it stays finite; the legacy branch keeps the
    tracked mask (screen admission included) as its weight."""
    if mixed and uniform is not None:
        raise ValueError("the mixed-family form reads the field columns: "
                         "it takes no uniform constants")
    def sc(c):
        return src[..., c:c + 1]

    xs, ys, cs, ss = sc(_SX), sc(_SY), sc(_SC), sc(_SS)
    dx = xr - xs
    dy = yr - ys
    rho2 = dx * dx + dy * dy
    inv_rho = torch.rsqrt(torch.clamp(rho2, min=1e-30))
    dxn = dx * inv_rho
    dyn = dy * inv_rho

    sin_rel = ss * cr - cs * sr
    sin2 = sin_rel * sin_rel
    if uniform is not None:
        e0u, e1u, s0u, s1u, s2u, s3u, chfu = uniform
        vdecay0 = s0u + s1u * sin2
        vd1h = 0.5 * s2u + (0.5 * s3u) * sin2
        e = e0u - e1u * sin2
        chf = -chfu
    else:
        vdecay0 = sc(_S0) + sc(_S1) * sin2
        vd1h = sc(_S2) * 0.5 + (sc(_S3) * 0.5) * sin2
        e = sc(_E0) - sc(_E1) * sin2
        chf = -sc(_CHF)
    if mixed:
        legacy = sc(_FAM) > 0.5
        e = torch.where(legacy, 0.0, e)
        vdecay0 = torch.where(legacy, 1.0, vdecay0)
        vd1h = torch.where(legacy, 0.0, vd1h)

    cosphi = dxn * cs + dyn * ss
    sinphi = dyn * cs - dxn * ss
    ax = dxn - cs
    ay = dyn - ss
    m4 = torch.clamp(ax * ax + ay * ay, min=_m4_floor(src.dtype))
    th = vd1h * torch.rsqrt(m4)
    sigma = vdecay0 - m4 * th
    ndsigm = th * sinphi
    ecos = e * cosphi
    ec2 = 1 - ecos * ecos

    sig_c = torch.clamp(sigma, min=1e-15)
    P = sc(_F0) * torch.exp(-torch.sqrt(rho2 * ec2)
                            * torch.rsqrt(sig_c * sig_c))
    u = ec2 * sigma
    v = (e * sinphi) * (ecos * sigma) + ec2 * ndsigm
    inv_m = torch.rsqrt(torch.clamp(u * u + v * v, min=1e-30))

    tracked = rho2 > 0.0
    if fov:
        tracked &= (dxn * cr + dyn * sr) <= chf
    if priority_p2r:
        tracked &= (dyn * cr - dxn * sr) >= 0
    tracked &= act_r > 0
    if strip:
        *lead, n_src, n_recv = rho2.shape
        strips = rho2.reshape(*lead, n_src // strip, strip * n_recv)
        admit = strips.amin(dim=-1, keepdim=True) <= cutoff2
        tracked &= admit.repeat_interleave(strip, dim=-2)

    w = torch.where(tracked, P * inv_m, 0.0)
    fx_pair = w * (u * dxn - v * dyn)
    fy_pair = w * (u * dyn + v * dxn)

    if mixed:
        # legacy v0.1 elliptic field (ops.forces.rep_force_legacy_pair in
        # the Pallas tile's operation order)
        rho = rho2 * inv_rho
        e_l, inv_se, inv_pd = sc(_E0), sc(_E1), sc(_S0)
        u_l = (1 - e_l * cosphi) * inv_se
        P_l = sc(_F0) * torch.exp(-rho * u_l * inv_pd)
        frho0 = P_l * u_l
        fphi0 = P_l * e_l * sinphi * inv_se
        w_l = tracked.to(src.dtype)
        fx_pair = torch.where(legacy, w_l * (frho0 * dxn - fphi0 * dyn),
                              fx_pair)
        fy_pair = torch.where(legacy, w_l * (frho0 * dyn + fphi0 * dxn),
                              fy_pair)

    return torch.sum(fx_pair, dim=-2), torch.sum(fy_pair, dim=-2)


def pair_forces_neighbors_ref(nbr, valid, src_pack, recv_pack, *,
                              block: int = 128, block_src: int = 0,
                              uniform=None, fov: bool = True,
                              priority_p2r: bool = False,
                              mixed: bool = False,
                              screen: bool = False, sub: int = 0,
                              cutoff: float = float("inf"),
                              chunk: int | None = None):
    """Plain PyTorch version of the block-sparse pair sum.

    nbr, valid : [B, KB] neighbor-block table (`ops.neighbors`)
    src_pack   : [N_src, 16] cell-sorted source fields
    recv_pack  : [8, B*block] cell-sorted receiver fields
    uniform    : optional (e_0, e_1, sigma_0..3, cos(hfov/2)) shared
                 field parameters; None reads the per-source columns
    fov        : the receiver sees a source only inside its half FOV cone
    priority_p2r : priority to the right, (dyn cr - dxn sr) >= 0
    mixed      : each source row's family by its column 13 (twod or
                 legacy); excludes `uniform`
    screen     : skip each (receiver block, table slot) tile, or with
                 sub > 0 each strip of `sub` sources of it, in which no
                 pair lies within `cutoff` (the Pallas kernel's screens)
    cutoff     : the screens' distance (the engine passes its cutoff
                 without the skin); ignored without `screen`
    chunk      : receiver blocks evaluated at a time (bounds memory;
                 default 64 on a GPU, 8 on the CPU, whose caches favour
                 the smaller working set)
    returns    : [2, B*block] summed (fx, fy) per receiver, sorted order
    """
    n_src = src_pack.shape[0]
    bcount, kb = nbr.shape
    block_src = block_src or block
    _check_shapes(nbr, valid, src_pack, recv_pack, block, block_src)
    _check_sub(block_src, sub)
    strip = (sub or block_src) if screen else 0
    cutoff2 = cutoff_squared(cutoff)
    if chunk is None:
        chunk = 8 if src_pack.device.type == "cpu" else 64
    src_blocks = src_pack.reshape(n_src // block_src, block_src, SRC_COLS)
    recv = recv_pack.reshape(RECV_ROWS, bcount, 1, block)
    out = src_pack.new_empty((2, bcount, block))
    for lo in range(0, bcount, chunk):
        hi = min(lo + chunk, bcount)
        src = src_blocks[nbr[lo:hi].long()]                # [C, KB, S, 16]
        # invalid slots: zero amplitude, so they contribute exactly 0
        src[..., _F0] *= valid[lo:hi, :, None].to(src.dtype)
        src = src.reshape(hi - lo, kb * block_src, SRC_COLS)
        r = recv[:, lo:hi]
        fx, fy = tile_forces(src, r[0], r[1], r[2], r[3], r[4],
                             uniform=uniform, fov=fov,
                             priority_p2r=priority_p2r, strip=strip,
                             cutoff2=cutoff2, mixed=mixed)
        out[0, lo:hi] = fx
        out[1, lo:hi] = fy
    return out.reshape(2, bcount * block)


def _check_shapes(nbr, valid, src_pack, recv_pack, block, block_src):
    bcount, kb = nbr.shape
    if valid.shape != nbr.shape:
        raise ValueError(f"valid {tuple(valid.shape)} != nbr "
                         f"{tuple(nbr.shape)}")
    if block % block_src != 0:
        raise ValueError(f"block_src ({block_src}) must divide block "
                         f"({block})")
    if src_pack.ndim != 2 or src_pack.shape[1] != SRC_COLS:
        raise ValueError(f"src_pack must be [N_src, {SRC_COLS}], got "
                         f"{tuple(src_pack.shape)}")
    if src_pack.shape[0] % block_src != 0:
        raise ValueError(f"N_src ({src_pack.shape[0]}) must be a multiple "
                         f"of block_src ({block_src})")
    if tuple(recv_pack.shape) != (RECV_ROWS, bcount * block):
        raise ValueError(f"recv_pack must be [{RECV_ROWS}, "
                         f"{bcount * block}], got {tuple(recv_pack.shape)}")


def _check_sub(block_src: int, sub: int):
    """The strip height of the strip screen: 0 (the tile screen), or a
    positive multiple of 8 that divides block_src (as the JAX package
    asserts)."""
    if sub and (sub < 0 or block_src % sub != 0 or sub % 8 != 0):
        raise ValueError(f"sub ({sub}) must divide block_src ({block_src}) "
                         f"and be a multiple of 8")


def _on_cuda(name, nbr, valid, src_pack, recv_pack) -> bool:
    """False for CPU inputs, True for inputs on one CUDA device; raises
    for anything else."""
    tensors = (nbr, valid, src_pack, recv_pack)
    devices = {t.device for t in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: all inputs must be on one CUDA device or "
                         f"all on the CPU, got {sorted(map(str, devices))}")
    return True


# the receiver blocks the CUDA kernels are compiled for (kBlock, a template
# parameter in csrc/)
KERNEL_BLOCKS = (64, 128, 256)


def _check_kernel_inputs(name, nbr, valid, src_pack, recv_pack, block,
                         block_src, count=None):
    _check_shapes(nbr, valid, src_pack, recv_pack, block, block_src)
    if block not in KERNEL_BLOCKS:
        raise ValueError(
            f"{name}: the CUDA kernels take receiver blocks of "
            f"{KERNEL_BLOCKS} (kBlock in csrc/, a template parameter), "
            f"got block = {block}: use one of them on CUDA tensors (any "
            f"block runs the plain version on CPU tensors)")
    if count is not None and (
            count.dtype != torch.int32 or count.device != nbr.device
            or tuple(count.shape) != (nbr.shape[0],)
            or not count.is_contiguous()):
        raise ValueError(f"{name}: count must be a contiguous int32 "
                         f"[{nbr.shape[0]}] tensor on the table's device")
    if src_pack.dtype != torch.float32 or recv_pack.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 packs")
    if nbr.dtype != torch.int32:
        raise TypeError(f"{name}: the CUDA kernel takes an int32 table")
    if not (nbr.is_contiguous() and src_pack.is_contiguous()
            and recv_pack.is_contiguous()):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    if src_pack.data_ptr() % 16:
        raise ValueError(f"{name}: the CUDA kernel reads src_pack 16 bytes "
                         f"at a time: it must be 16-byte aligned")


def _field_args(uniform, mixed=False):
    """(uniform flag, the 7 shared field parameters) for a launcher."""
    if mixed and uniform is not None:
        raise ValueError("the mixed-family form reads the field columns: "
                         "it takes no uniform constants")
    if uniform is None:
        return 0, (0.0,) * 7
    if len(uniform) != 7:
        raise ValueError("uniform must hold (e_0, e_1, sigma_0..3, "
                         "cos(hfov/2))")
    return 1, tuple(float(u) for u in uniform)


def _launch(name, symbol, nbr, valid, count, src_pack, recv_pack, block,
            *args):
    """Run the C launcher `symbol` on the packs' device and current
    stream (under a CUDA-graph capture the capturing stream, so the launch
    is recorded); the [2, B*block] float32 output. `count` [B] int32 is
    the valid entries per table row (`valid` is a prefix of each row);
    None counts them here."""
    from cyclistsocialforce_tpu_torch.ops import _build

    lib = _build.library()
    bcount, kb = nbr.shape
    if count is None:
        count = valid.sum(dim=1, dtype=torch.int32)
    out = torch.empty((2, bcount * block), dtype=torch.float32,
                      device=src_pack.device)
    device = src_pack.device
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, symbol)(
        nbr.data_ptr(), count.data_ptr(), src_pack.data_ptr(),
        recv_pack.data_ptr(), out.data_ptr(), bcount, kb, block, *args,
        device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed "
                           f"({_build.error_string(lib, rc)})")
    return out


def pair_forces_neighbors(nbr, valid, src_pack, recv_pack, *,
                          block: int = 128, block_src: int = 0,
                          uniform=None, fov: bool = True,
                          priority_p2r: bool = False, mixed: bool = False,
                          screen: bool = False, sub: int = 0,
                          cutoff: float = float("inf"), count=None):
    """K1: block-sparse pair sum, one source tile at a time. The CUDA
    kernel on CUDA tensors, the plain version on CPU tensors; arguments
    and result as in `pair_forces_neighbors_ref`. `count` [B] int32, the
    valid entries per table row, saves the kernel's wrapper a reduction
    of `valid` when the caller keeps it with the table.

    The kernel takes float32 packs, an int32 table and a block in
    `KERNEL_BLOCKS`. It splits each receiver block's table slots over its
    thread groups (8 at block 128, two receivers per thread) and adds the
    groups' sums in a fixed order, so a call gives the same result every
    time. It decides every pair (FOV
    cone, priority to the right, the sign(sin phi) jump) with the plain
    version's rounding, and evaluates the smooth rest of the field with
    fused multiply-adds and the GPU's approximate exp2 and rsqrt: within
    a few float32 ulps of each pair force of the plain version."""
    block_src = block_src or block
    _check_sub(block_src, sub)
    is_uniform, field = _field_args(uniform, mixed)
    if not _on_cuda("pair_forces_neighbors", nbr, valid,
                    src_pack, recv_pack):
        return pair_forces_neighbors_ref(
            nbr, valid, src_pack, recv_pack, block=block,
            block_src=block_src, uniform=uniform, fov=fov,
            priority_p2r=priority_p2r, mixed=mixed, screen=screen, sub=sub,
            cutoff=cutoff)
    _check_kernel_inputs("pair_forces_neighbors", nbr, valid, src_pack,
                         recv_pack, block, block_src, count)
    out = _launch("pair_forces_neighbors", "csf_pair_forces_twod", nbr,
                  valid, count, src_pack, recv_pack, block, block_src,
                  is_uniform, int(mixed), int(fov), int(priority_p2r),
                  int(screen), (sub or block_src), cutoff_squared(cutoff),
                  *field)
    _count(pair_forces_neighbors)
    return out


def pair_forces_neighbors_unrolled(nbr, valid, src_pack, recv_pack, *,
                                   block: int = 128, block_src: int = 0,
                                   uniform=None, fov: bool = True,
                                   priority_p2r: bool = False,
                                   mixed: bool = False, count=None):
    """K2: block-sparse pair sum with every source tile of a receiver
    block staged before the sum, and no distance screen. The CUDA kernel
    on CUDA tensors, the plain version (unscreened) on CPU tensors;
    arguments and result as in `pair_forces_neighbors_ref`; `count` as in
    `pair_forces_neighbors`.

    The kernel takes float32 packs, an int32 table and a block in
    `KERNEL_BLOCKS`. It stages a receiver block's source tiles in shared memory by bulk
    copies, each tile reporting its own arrival, in rounds of at most
    96 KB (the main path's kb = 19 at block_src = 64 is one round), so
    any kb is taken. The block's thread groups (8 at block 128, two
    receivers per thread) split a round's source rows evenly and wait only for the
    tiles they read; their sums are added in a fixed order, so a call
    gives the same result every time. Per pair it is K1's math: every
    decision (FOV cone, priority to the right, the sign(sin phi) jump)
    rounds as the plain version's, the smooth rest is fused and uses the
    GPU's approximate exp2 and rsqrt, within a few float32 ulps of each
    pair force of the plain version."""
    block_src = block_src or block
    is_uniform, field = _field_args(uniform, mixed)
    if not _on_cuda("pair_forces_neighbors_unrolled", nbr, valid,
                    src_pack, recv_pack):
        return pair_forces_neighbors_ref(
            nbr, valid, src_pack, recv_pack, block=block,
            block_src=block_src, uniform=uniform, fov=fov,
            priority_p2r=priority_p2r, mixed=mixed)
    _check_kernel_inputs("pair_forces_neighbors_unrolled", nbr, valid,
                         src_pack, recv_pack, block, block_src, count)
    out = _launch("pair_forces_neighbors_unrolled",
                  "csf_pair_forces_unrolled", nbr, valid, count, src_pack,
                  recv_pack, block, block_src, is_uniform, int(mixed),
                  int(fov), int(priority_p2r), *field)
    _count(pair_forces_neighbors_unrolled)
    return out


def pair_forces_neighbors_db(nbr, valid, src_pack, recv_pack, *,
                             block: int = 128, fov: bool = True,
                             priority_p2r: bool = False,
                             mixed: bool = False,
                             cutoff: float = float("inf"), count=None):
    """K3: block-sparse pair sum through a ring of `block`-row source
    tiles, each skipped when no pair of it lies within `cutoff` (the tile
    screen, always on), with the field parameters read per source row
    (with `mixed`, each row's own family). Source and receiver blocks
    are both `block` agents (one of `KERNEL_BLOCKS` on CUDA tensors). The CUDA kernel on CUDA tensors, the
    plain version (screened, per-source columns) on CPU tensors; result
    as in `pair_forces_neighbors_ref`; `count` as in
    `pair_forces_neighbors`.

    The kernel takes float32 packs and an int32 table. Tiles stream
    through a 4-slot ring in shared memory: a bulk copy fills a slot and
    reports to the slot's barrier, and the last warp to finish a tile
    starts the copy of the tile 4 slots on. Each of the block's thread
    groups (8 at block 128, two receivers per thread) takes its strip of
    every tile (16 rows at block 128). A tile is skipped exactly when the
    plain version skips it: every group votes on its rows (inactive and
    pad rows included), one group in range admits the tile for all, and
    a group out of range waits for the others' votes. The groups' sums are added in a fixed order, so a
    call gives the same result every time; per pair it is K1's math
    (decisions rounded as the plain version's, the smooth rest fused,
    within a few float32 ulps of each pair force)."""
    if not _on_cuda("pair_forces_neighbors_db", nbr, valid,
                    src_pack, recv_pack):
        return pair_forces_neighbors_ref(
            nbr, valid, src_pack, recv_pack, block=block, block_src=block,
            fov=fov, priority_p2r=priority_p2r, mixed=mixed, screen=True,
            cutoff=cutoff)
    _check_kernel_inputs("pair_forces_neighbors_db", nbr, valid, src_pack,
                         recv_pack, block, block, count)
    out = _launch("pair_forces_neighbors_db", "csf_pair_forces_db", nbr,
                  valid, count, src_pack, recv_pack, block, int(mixed),
                  int(fov), int(priority_p2r), cutoff_squared(cutoff))
    _count(pair_forces_neighbors_db)
    return out


def _count(fn):
    """One more launch of `fn`'s kernel. Into a CUDA-graph capture the
    launch is only recorded, and runs once per replay of the graph: it
    counts as captured, and whoever replays the graph counts the replays
    (`engine.ChunkRunner`)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


# per kernel: launches since the last reset (the plain version never
# counts), and launches recorded into CUDA-graph captures
KERNELS = (pair_forces_neighbors, pair_forces_neighbors_unrolled,
           pair_forces_neighbors_db)
for _fn in KERNELS:
    _fn.launches = 0
    _fn.captured = 0


def reset_launches():
    """Set every kernel's launch counter to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> tuple:
    """Every kernel's launch counter, in `KERNELS` order."""
    return tuple(fn.launches for fn in KERNELS)


def captured_counts() -> tuple:
    """Every kernel's count of launches recorded into CUDA-graph captures
    since the module was loaded, in `KERNELS` order."""
    return tuple(fn.captured for fn in KERNELS)
