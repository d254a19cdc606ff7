"""Block-sparse pairwise repulsive-force sum: the CUDA kernel's wrapper,
its plain PyTorch version, and the kernel's launch counter.

Port of `cyclistsocialforce_tpu.ops.pallas_forces.pair_forces_neighbors`
(the Pallas `_pair_kernel` with the tile math `_tile_forces`). Agents are
cell-sorted and blocked (`ops.neighbors`); each receiver block sums the
BMD2023 "twod" field of the sources in its neighbor-block table.

Packing layout (built by `engine.Engine.pack_pair_fields`, cell-sorted):
  src_pack  [N_src, 16]: x, y, cos psi, sin psi, f_0 * emit, e_0, e_1,
                         sigma_0..3, cos(hfov/2), emit, (unused), (unused),
                         receiver activity flag
  recv_pack [8, N]:      x, y, cos psi, sin psi, active, (unused) x 3
The emit flag (active AND f_0 > 0) is folded into column 4, so a
non-emitting source contributes P = 0 with no mask of its own.

`pair_forces_neighbors` runs the CUDA kernel (`csrc/pair_forces.cu`) on
CUDA tensors and the plain version on CPU tensors; it raises for any
other input. The kernel serves the configuration the main path runs:
shared field parameters (`uniform`), the FOV cone on, block = 128.
"""

from __future__ import annotations

import torch

SRC_COLS = 16
RECV_ROWS = 8
_SX, _SY, _SC, _SS, _F0, _E0, _E1, _S0, _S1, _S2, _S3, _CHF, _SACT = range(13)
_RACT = 15

# half-angle floor m4 >= 4e-12 of the float32 tile (see _tile_forces),
# scaled for wider dtypes by the square of the machine-epsilon ratio so
# that it bounds the same rounding-decoupled case and nothing more
_M4_FLOOR_F32 = 4e-12


def _m4_floor(dtype) -> float:
    ratio = torch.finfo(dtype).eps / torch.finfo(torch.float32).eps
    return _M4_FLOOR_F32 * ratio * ratio


def tile_forces(src, xr, yr, cr, sr, act_r, uniform=None, fov=True):
    """Field of sources `src` [..., S, 16] at receivers (xr, yr, cr, sr,
    act_r) [..., 1, R], summed over the sources: (fx, fy) [..., R].

    The algebra of the Pallas tile (`pallas_forces._tile_forces`), in the
    input's dtype: the unit separation vector from one rsqrt, the
    one-rsqrt half-angle form in m4 = |u_rho - u_psi|^2 = 4 sin^2(phi/2),
    which interpolates through the reference's sign(sin phi) jump at
    phi = 0, and the force direction (u, v) rescaled by sigma^2 sqrt(ec2)."""
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
    tracked &= act_r > 0

    w = torch.where(tracked, P * inv_m, 0.0)
    fx = torch.sum(w * (u * dxn - v * dyn), dim=-2)
    fy = torch.sum(w * (u * dyn + v * dxn), dim=-2)
    return fx, fy


def pair_forces_neighbors_ref(nbr, valid, src_pack, recv_pack, *,
                              block: int = 128, block_src: int = 0,
                              uniform=None, fov: bool = True,
                              chunk: int | None = None):
    """Plain PyTorch version of the block-sparse pair sum.

    nbr, valid : [B, KB] neighbor-block table (`ops.neighbors`)
    src_pack   : [N_src, 16] cell-sorted source fields
    recv_pack  : [8, B*block] cell-sorted receiver fields
    uniform    : optional (e_0, e_1, sigma_0..3, cos(hfov/2)) shared
                 field parameters; None reads the per-source columns
    chunk      : receiver blocks evaluated at a time (bounds memory;
                 default 64 on a GPU, 8 on the CPU, whose caches favour
                 the smaller working set)
    returns    : [2, B*block] summed (fx, fy) per receiver, sorted order
    """
    n_src = src_pack.shape[0]
    bcount, kb = nbr.shape
    block_src = block_src or block
    _check_shapes(nbr, valid, src_pack, recv_pack, block, block_src)
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
                             uniform=uniform, fov=fov)
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


def pair_forces_neighbors(nbr, valid, src_pack, recv_pack, *,
                          block: int = 128, block_src: int = 0,
                          uniform=None, fov: bool = True,
                          priority_p2r: bool = False, mixed: bool = False,
                          screen: bool = False, sub: int = 0):
    """Block-sparse pair sum: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. Arguments and result as in
    `pair_forces_neighbors_ref`.

    The kernel takes float32 packs, an int32 table, block = 128, the
    shared-parameter form (`uniform`) and the FOV cone on. The static
    variants of the Pallas kernel that the main path does not run
    (priority_p2r, mixed, screen/sub, fov=False, uniform=None) raise
    NotImplementedError on CUDA tensors; the plain version serves
    fov=False and uniform=None."""
    if priority_p2r or mixed or screen or sub:
        raise NotImplementedError(
            "pair_forces_neighbors: priority_p2r, mixed and screen/sub "
            "variants are not ported")
    block_src = block_src or block
    devices = {t.device.type for t in (nbr, valid, src_pack, recv_pack)}
    if devices == {"cpu"}:
        return pair_forces_neighbors_ref(
            nbr, valid, src_pack, recv_pack, block=block,
            block_src=block_src, uniform=uniform, fov=fov)
    if devices != {"cuda"} or len({t.device for t in (
            nbr, valid, src_pack, recv_pack)}) != 1:
        raise ValueError("pair_forces_neighbors: all inputs must be on one "
                         f"CUDA device or all on the CPU, got {devices}")
    if uniform is None or not fov:
        raise NotImplementedError(
            "the CUDA pair kernel serves shared field parameters "
            "(uniform) with the FOV cone on")
    _check_shapes(nbr, valid, src_pack, recv_pack, block, block_src)
    if block != 128:
        raise ValueError(f"the CUDA pair kernel needs block = 128, got "
                         f"{block}")
    if src_pack.dtype != torch.float32 or recv_pack.dtype != torch.float32:
        raise TypeError("the CUDA pair kernel takes float32 packs")
    if nbr.dtype != torch.int32:
        raise TypeError("the CUDA pair kernel takes an int32 table")
    if not (nbr.is_contiguous() and src_pack.is_contiguous()
            and recv_pack.is_contiguous()):
        raise ValueError("the CUDA pair kernel takes contiguous tensors")
    if src_pack.data_ptr() % 16:
        raise ValueError("the CUDA pair kernel reads src_pack as float4: "
                         "it must be 16-byte aligned")
    if len(uniform) != 7:
        raise ValueError("uniform must hold (e_0, e_1, sigma_0..3, "
                         "cos(hfov/2))")

    from cyclistsocialforce_tpu_torch.ops import _build

    lib = _build.library()
    bcount, kb = nbr.shape
    count = valid.sum(dim=1, dtype=torch.int32)
    out = torch.empty((2, bcount * block), dtype=torch.float32,
                      device=src_pack.device)
    e0, e1, s0, s1, s2, s3, chf = (float(u) for u in uniform)
    device = src_pack.device
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.csf_pair_forces_twod(
        nbr.data_ptr(), count.data_ptr(), src_pack.data_ptr(),
        recv_pack.data_ptr(), out.data_ptr(), bcount, kb, block_src,
        e0, e1, s0, s1, s2, s3, chf, device.index, stream)
    if rc != 0:
        raise RuntimeError(f"pair_forces_neighbors: CUDA launch failed "
                           f"({_build.error_string(lib, rc)})")
    pair_forces_neighbors.launches += 1
    return out


# kernel launches since the last reset (the plain version never counts)
pair_forces_neighbors.launches = 0
