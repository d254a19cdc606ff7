"""Social-force field evaluations of the PyTorch port (counterpart of
`cyclistsocialforce_tpu.ops.forces`): the pairwise repulsive fields in
their reference form, the foe mask of the dense pair stage, the
destination forces and the force combination. Forces have velocity
semantics: |F| is the desired speed, atan2(Fy, Fx) the desired heading.

The pair functions are elementwise over broadcast [S, R] (source,
receiver) operands, so the dense stage (`engine.Engine.repulsive_sum`)
evaluates them over [N, N] or over receiver chunks. The culled stage does
not use them: its kernels and their plain version (`ops.pair_forces`)
compute the same fields in the Pallas tile's algebra.
"""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.utils.angles import limit_magnitude

# ---- pairwise repulsive fields ---------------------------------------------


def rep_force_twod_pair(dx, dy, cos_src, sin_src, cos_recv, sin_recv,
                        f_0, e_0, e_1, sigma_0, sigma_1, sigma_2, sigma_3):
    """Anisotropic elliptic repulsive force of the BMD2023 2D model
    (reference TwoDBicycle.calcRepulsiveForce, vehicle.py:1560-1648), in
    the trig-free form of the JAX package: headings enter as (cos, sin)
    pairs, cos phi is clipped to [-1, 1] and d sigma / d phi takes
    sign(sin phi).

    Force of a source on a receiver at (dx, dy) = receiver - source;
    parameters are the source's. Returns (Fx, Fy); zero-distance pairs and
    f_0 == 0 sources give 0."""
    sin_rel = sin_src * cos_recv - cos_src * sin_recv
    sin2 = sin_rel * sin_rel

    vdecay0 = sigma_0 + sigma_1 * sin2
    vdecay1 = sigma_2 + sigma_3 * sin2
    e = e_0 - e_1 * sin2

    rho = torch.sqrt(dx * dx + dy * dy)
    safe = torch.where(rho > 0, rho, 1.0)
    cosphi = torch.clamp((dx * cos_src + dy * sin_src) / safe, -1.0, 1.0)
    sinphi = (dy * cos_src - dx * sin_src) / safe

    sigma = vdecay0 - vdecay1 * torch.sqrt((1 - cosphi) / 2)
    # d(sigma)/d(phi); sign(phi) == sign(sin(phi)) on (-pi, pi)
    dsigm = -vdecay1 * torch.sqrt((1 + cosphi) / 2) * torch.sign(sinphi) / 2

    ec2 = 1 - (e * cosphi) ** 2
    sq = torch.sqrt(ec2)

    P = f_0 * torch.exp(-rho * sq / sigma)

    frho = P * sq / sigma
    fphi = (-P * (ec2 * dsigm - e**2 * sinphi * cosphi * sigma)
            / (sigma**2 * sq))

    # rotate (frho, fphi) to world axes, renormalized to magnitude P
    fmag = torch.sqrt(frho * frho + fphi * fphi)
    fmag = torch.where(fmag > 0, fmag, 1.0)
    scale = P / (fmag * safe)
    fx = scale * (frho * dx - fphi * dy)
    fy = scale * (frho * dy + fphi * dx)

    zero = (f_0 == 0.0) | (rho == 0.0)
    return torch.where(zero, 0.0, fx), torch.where(zero, 0.0, fy)


def rep_force_twod(dx, dy, psi_src, psi_recv, f_0, e_0, e_1,
                   sigma_0, sigma_1, sigma_2, sigma_3):
    """`rep_force_twod_pair` in the reference's signature: headings in
    radians (reference vehicle.py:1560-1648)."""
    return rep_force_twod_pair(
        dx, dy, torch.cos(psi_src), torch.sin(psi_src),
        torch.cos(psi_recv), torch.sin(psi_recv),
        f_0, e_0, e_1, sigma_0, sigma_1, sigma_2, sigma_3)


def rep_force_legacy_pair(dx, dy, cos_src, sin_src, e, inv_se,
                          inv_pdecay, amp):
    """Legacy v0.1 elliptic repulsive force (reference
    Bicycle.calcPotential/calcRepulsiveForce, vehicle.py:1054-1147):
    P = amp exp(-rho (1 - e cos phi0) inv_se inv_pdecay) with
    amp = p_0/p_decay, inv_se = 1/sqrt(1-e^2); force (P u, P e sin phi0
    inv_se) with u = (1 - e cos phi0) inv_se, rotated to world axes.
    Zero-distance pairs give 0."""
    rho = torch.sqrt(dx * dx + dy * dy)
    safe = torch.where(rho > 0, rho, 1.0)
    cosphi0 = (dx * cos_src + dy * sin_src) / safe
    sinphi0 = (dy * cos_src - dx * sin_src) / safe

    u = (1 - e * cosphi0) * inv_se
    P = amp * torch.exp(-rho * u * inv_pdecay)

    frho0 = P * u
    fphi0 = P * e * sinphi0 * inv_se
    fx = (frho0 * dx - fphi0 * dy) / safe
    fy = (frho0 * dy + fphi0 * dx) / safe
    zero = rho == 0.0
    return torch.where(zero, 0.0, fx), torch.where(zero, 0.0, fy)


def legacy_excentricity(v_src, v_max_riding_fwd):
    """Speed-dependent excentricity of the legacy field,
    e = min((v / v_max)^0.1, 0.7) (reference vehicle.py:1093-1095).
    Negative speeds (possible while braking) are clamped to 0, where the
    reference gives NaN."""
    v = torch.clamp(v_src, min=0.0)
    return torch.clamp(torch.pow(v / v_max_riding_fwd, 0.1), max=0.7)


def potential_legacy(dx, dy, psi_src, v_src, v_max_riding_fwd, p_0,
                     p_decay):
    """Legacy elliptic repulsive POTENTIAL of a source at offsets (dx, dy)
    from it (reference Bicycle.calcPotential, vehicle.py:1066-1104):
    P = p_0 exp(-rho (1 - e cos phi0) / (sqrt(1 - e^2) p_decay)) with the
    speed-dependent excentricity e."""
    e = legacy_excentricity(v_src, v_max_riding_fwd)
    inv_se = 1.0 / torch.sqrt(1 - e**2)
    rho = torch.sqrt(dx * dx + dy * dy)
    safe = torch.where(rho > 0, rho, 1.0)
    cosphi0 = (dx * torch.cos(psi_src) + dy * torch.sin(psi_src)) / safe
    u = (1 - e * torch.where(rho > 0, cosphi0, 1.0)) * inv_se
    return p_0 * torch.exp(-rho * u / p_decay)


def rep_force_legacy(dx, dy, psi_src, v_src, v_max_riding_fwd, p_0,
                     p_decay):
    """`rep_force_legacy_pair` in the reference's signature (reference
    vehicle.py:1054-1147). Parameters are the SOURCE's."""
    e = legacy_excentricity(v_src, v_max_riding_fwd)
    inv_se = 1.0 / torch.sqrt(1 - e**2)
    return rep_force_legacy_pair(
        dx, dy, torch.cos(psi_src), torch.sin(psi_src), e, inv_se,
        1.0 / p_decay, p_0 / p_decay)


# ---- foe masking and dense assembly ----------------------------------------


def untracked_foes_tile(x_src, y_src, idx_src, active_src, hfov_src,
                        x_recv, y_recv, psi_recv, idx_recv, active_recv,
                        priority_p2r: bool = False):
    """[S, R] mask "receiver j does not react to source i" (reference
    SocialForceIntersection.get_untracked_foes, intersection.py:690-745,
    with its quirk that the FOV threshold is the SOURCE's hfov): True when
    source i lies outside receiver j's half-FOV cone of source i's hfov,
    for the self-pair and coincident pairs, for either side inactive, and
    under priority to the right when the source lies to the left."""
    dx = x_src[:, None] - x_recv[None, :]
    dy = y_src[:, None] - y_recv[None, :]
    cr = torch.cos(psi_recv)[None, :]
    sr = torch.sin(psi_recv)[None, :]
    rho_cos_rel = dx * cr + dy * sr
    rho_sin_rel = dy * cr - dx * sr
    rho = torch.sqrt(dx * dx + dy * dy)
    safe = torch.where(rho > 0, rho, 1.0)

    cos_half_hfov = torch.cos(hfov_src / 2)[:, None]
    untracked = rho_cos_rel / safe < cos_half_hfov
    untracked = untracked | (idx_src[:, None] == idx_recv[None, :])
    untracked = untracked | (rho == 0.0)
    if priority_p2r:
        untracked = untracked | (rho_sin_rel > 0)
    untracked = untracked | ~active_src[:, None] | ~active_recv[None, :]
    return untracked


def untracked_foes(x, y, psi, hfov, active=None,
                   priority_p2r: bool = False):
    """Dense [N, N] foe mask (i = source, j = receiver); see
    `untracked_foes_tile`. `hfov` is a float or an [N] tensor."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=x.device)
    hfov = torch.as_tensor(hfov, dtype=x.dtype, device=x.device).expand(n)
    return untracked_foes_tile(x, y, idx, active, hfov, x, y, psi, idx,
                               active, priority_p2r=priority_p2r)


def sum_sources(fx_pair, fy_pair, tracked):
    """Mask untracked pairs and sum the repulsive force over the source
    axis (reference intersection.py:822-838)."""
    frep_x = torch.sum(torch.where(tracked, fx_pair, 0.0), dim=0)
    frep_y = torch.sum(torch.where(tracked, fy_pair, 0.0), dim=0)
    return frep_x, frep_y


def clamp_add_dest(frep_x, frep_y, fdest_x, fdest_y):
    """Clamp the summed repulsive force to the destination-force magnitude
    and add the destination force (reference intersection.py:841-848)."""
    fdest_mag = torch.sqrt(fdest_x * fdest_x + fdest_y * fdest_y)
    frep_x, frep_y = limit_magnitude(frep_x, frep_y, fdest_mag)
    return frep_x + fdest_x, frep_y + fdest_y


def sum_repulsive(fx_pair, fy_pair, tracked, fdest_x, fdest_y):
    """Mask, sum over the sources, clamp to the destination-force
    magnitude and add the destination force (reference
    intersection.py:822-848)."""
    frep_x, frep_y = sum_sources(fx_pair, fy_pair, tracked)
    return clamp_add_dest(frep_x, frep_y, fdest_x, fdest_y)


# ---- destination forces ----------------------------------------------------


def dest_force_straight(x, y, dest_x, dest_y, vd, ddest):
    """Straight-line destination force (reference vehicle.py:1150-1187):
    points from (x, y) to the destination with magnitude vd; zero at
    ddest == 0."""
    ok = ddest > 0
    safe = torch.where(ok, ddest, 1.0)
    fx = torch.where(ok, -vd * (x - dest_x) / safe, 0.0)
    fy = torch.where(ok, -vd * (y - dest_y) / safe, 0.0)
    return fx, fy


def dest_force_hm(fx_straight, fy_straight, v, psi, v_desired,
                  relax: float = 3.0):
    """Helbing-Molnar destination force with acceleration semantics
    (reference vehicle.py:1196-1216): relaxes the current velocity toward
    v_desired along the straight-line direction. At the destination (zero
    straight force, where the reference divides 0/0) the force is 0."""
    r = torch.sqrt(fx_straight**2 + fy_straight**2)
    safe = torch.where(r > 0, r, 1.0)
    ex = fx_straight / safe
    ey = fy_straight / safe
    fx = (1 / relax) * (v_desired * ex - v * torch.cos(psi))
    fy = (1 / relax) * (v_desired * ey - v * torch.sin(psi))
    ok = r > 0
    return torch.where(ok, fx, 0.0), torch.where(ok, fy, 0.0)


# ---- infrastructure forces ---------------------------------------------------

# elements of one [M, V] temporary of `road_edge_force` (vertex chunks)
ROAD_CHUNK_ELEMENTS = 1 << 22


def road_edge_force(x, y, vertices, weights, F_0, sigma):
    """Inverse-power repulsion from road-edge polyline vertices (reference
    RoadEdge.calcRepulsiveForce, intersection.py:226-242): each vertex
    repels with magnitude F_0 r^-sigma along the unit vector away from it,
    summed over the vertices. x, y [M] evaluation points; vertices [V, 2];
    weights [V] (1 real, 0 padding); F_0, sigma numbers or [V]. The
    vertices are taken in chunks of at most ROAD_CHUNK_ELEMENTS // M, the
    chunks' sums added in order (one chunk for the JAX package's sizes)."""
    m, n_v = x.shape[0], vertices.shape[0]
    step = max(1, ROAD_CHUNK_ELEMENTS // max(m, 1))
    fx = fy = 0.0

    def per_vertex(value, lo, hi):
        if isinstance(value, torch.Tensor) and value.ndim:
            return value[None, lo:hi]
        return value

    for lo in range(0, n_v, step):
        hi = min(lo + step, n_v)
        dx = vertices[None, lo:hi, 0] - x[:, None]
        dy = vertices[None, lo:hi, 1] - y[:, None]
        r = torch.sqrt(dx**2 + dy**2)
        far = r > 0
        r_safe = torch.where(far, r, 1.0)
        f = (-per_vertex(F_0, lo, hi) * r_safe ** -per_vertex(sigma, lo, hi)
             * weights[None, lo:hi])
        fx = fx + torch.where(far, f * dx / r_safe, 0.0).sum(dim=1)
        fy = fy + torch.where(far, f * dy / r_safe, 0.0).sum(dim=1)
    return fx, fy
