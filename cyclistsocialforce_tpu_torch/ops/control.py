"""Controller primitives of the PyTorch port (counterpart of
`cyclistsocialforce_tpu.ops.control`): the PID step, Ackermann pole
placement of single-input systems, the DC gain, and the exact zero- and
first-order-hold discretizations through the augmented matrix exponential
(`ops.smallmat.expm_small` where the JAX package calls `jsl.expm`).

Every function is batched over leading axes ([..., n, n] matrices, [..., n]
vectors) and built on `ops.smallmat`: no host read, no shape that depends
on the data, so a CUDA graph can capture it."""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.ops.smallmat import (expm_small,
                                                       matmul_small,
                                                       matvec_small,
                                                       solve_small)


def pid_step(e, e_prev, i_prev, kp, ki, kd, dt):
    """One PID step (reference dynamics.py:33-54), with its derivative
    sign convention d = kd * (e_prev - e) / dt and the integral using the
    NEW error. Returns (out, e, i_new)."""
    d = kd * (e_prev - e) / dt
    i_new = i_prev + ki * e * dt
    out = kp * e + i_new + d
    return out, e, i_new


def poly_from_roots(roots):
    """Monic polynomial coefficients [..., n + 1] (highest power first) of
    the roots [..., n]. Complex roots must come in conjugate pairs for a
    real polynomial; the caller takes the real part."""
    n = roots.shape[-1]
    # lowest-power-first accumulation: p <- p * (x - r) = shift(p) - r p
    c = torch.zeros(roots.shape[:-1] + (n + 1,), dtype=roots.dtype,
                    device=roots.device)
    c[..., 0] = 1.0
    for k in range(n):
        shifted = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]],
                            dim=-1)
        c = shifted - roots[..., k:k + 1] * c
    return torch.flip(c, dims=(-1,))


def charpoly_from_pole_features(feats):
    """Monic characteristic polynomial [..., m + 1] (highest power first)
    of the pole set encoded by ImRe pole features [..., m],
    ``[p0_real, p1_real, p1_imag, p2_real, p2_imag]``: the poles [p0,
    p1 +/- j q1, p2 +/- j q2] (the reference's ordering in
    update_control_params, parameters.py:1397-1411). In real arithmetic,
    (s - p0) (s^2 - 2 p1 s + p1^2 + q1^2) (s^2 - 2 p2 s + p2^2 + q2^2),
    each quadratic factor multiplied in by its explicit products; the
    degree follows from m (5: quintic, 3: cubic, 1: linear)."""
    one = torch.ones_like(feats[..., 0])
    poly = [one, -feats[..., 0]]
    m = feats.shape[-1]
    i = 1
    while i + 1 < m:
        p, q = feats[..., i], feats[..., i + 1]
        quad = (one, -2.0 * p, p * p + q * q)
        # the product of poly (degree d) and quad: coefficient k sums
        # poly[j] * quad[k - j] over the j in range, j ascending
        poly = [sum(poly[j] * quad[k - j]
                    for j in range(max(0, k - 2), min(k, len(poly) - 1) + 1))
                for k in range(len(poly) + 2)]
        i += 2
    return torch.stack(poly, dim=-1)


def _ctrb_dual(A, B):
    """y = ctrb(A, B)^-T e_n of a single-input system (A [..., n, n], B
    [..., n])."""
    n = A.shape[-1]
    cols = [B]
    for _ in range(n - 1):
        cols.append(matvec_small(A, cols[-1]))
    ctrb = torch.stack(cols, dim=-1)
    en = torch.zeros(A.shape[:-1], dtype=A.dtype, device=A.device)
    en[..., -1] = 1.0
    return solve_small(ctrb.transpose(-1, -2), en)


def ackermann(A, B, coeffs):
    """Ackermann gain K = e_n^T ctrb(A, B)^-1 phi(A) [..., n] of a
    single-input system (A [..., n, n], B [..., n] or [..., n, 1]), phi the
    desired monic characteristic polynomial `coeffs` [..., n + 1] (highest
    power first). phi(A) is never formed: K = y^T phi(A) with ctrb^T y =
    e_n, by Horner on the vector, r <- A^T r + c_k y."""
    if B.ndim == A.ndim:
        B = B[..., 0]
    n = A.shape[-1]
    y = _ctrb_dual(A, B)
    At = A.transpose(-1, -2)
    r = coeffs[..., 0:1] * y                 # monic: coeffs[0] == 1
    for k in range(1, n + 1):
        r = matvec_small(At, r) + coeffs[..., k:k + 1] * y
    return r


def ackermann_basis(A, B):
    """Basis [..., n + 1, n] of the Ackermann gain as a function of the
    characteristic coefficients: row k is (A^T)^(n-k) y with y =
    ctrb(A, B)^-T e_n, so `ackermann(A, B, coeffs)` equals `coeffs @ M`
    for any monic polynomial (K is linear in the coefficients; see the
    Horner recursion in `ackermann`). Tabulated over speed, it gives
    per-rider placement at lookup cost with exact pole features (the
    stochastic gain forms)."""
    if B.ndim == A.ndim:
        B = B[..., 0]
    n = A.shape[-1]
    y = _ctrb_dual(A, B)
    At = A.transpose(-1, -2)
    rows = [y]
    for _ in range(n):
        rows.append(matvec_small(At, rows[-1]))
    return torch.stack(rows[::-1], dim=-2)


def place_siso(A, B, poles):
    """Ackermann pole placement of a single-input system, the closed-form
    equivalent of `ct.place(A, B, poles)` (placement is unique for one
    input, so the algorithms agree; the reference calls it per step,
    dynamics.py:1167-1227). A [..., n, n], B [..., n] or [..., n, 1],
    poles [..., n] complex (conjugate pairs); returns K [..., n]. Unlike
    `ackermann`, it forms phi(A) by Horner on the matrix and takes the
    last row of ctrb^-1 phi(A), as the JAX function does."""
    if B.ndim == A.ndim:
        B = B[..., 0]
    n = A.shape[-1]
    cols = [B]
    for _ in range(n - 1):
        cols.append(matvec_small(A, cols[-1]))
    ctrb = torch.stack(cols, dim=-1)
    cdt = torch.complex128 if A.dtype == torch.float64 else torch.complex64
    poles = torch.as_tensor(poles, dtype=cdt, device=A.device)
    coeffs = poly_from_roots(poles).real.to(A.dtype)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    phiA = torch.zeros_like(A)
    for k in range(n + 1):
        phiA = matmul_small(phiA, A) + coeffs[..., k, None, None] * eye
    # K = e_n^T ctrb^-1 phi(A): the last row of the solve
    return solve_small(ctrb, phiA)[..., -1, :]


def dc_gain(Acl, B, C):
    """Steady-state output y_ss = -C Acl^-1 B [...] of a stable closed
    loop under a unit step (Acl [..., n, n], B [..., n], C [..., n] or
    [..., 1, n])."""
    if B.ndim == Acl.ndim:
        B = B[..., 0]
    x_ss = -solve_small(Acl, B)
    return torch.sum(C.reshape(x_ss.shape) * x_ss, dim=-1)


def _augmented_expm(blocks, size, like):
    """expm of the [..., size, size] matrix holding `blocks`, a list of
    (row slice, column slice, [..., r, c] values), and zeros elsewhere."""
    aug = torch.zeros(like.shape[:-2] + (size, size), dtype=like.dtype,
                      device=like.device)
    for rows, cols, val in blocks:
        aug[..., rows, cols] = val
    return expm_small(aug)


def _dt(dt):
    """dt as a factor of [..., r, c] blocks: a number, or a [...] tensor."""
    return dt[..., None, None] if isinstance(dt, torch.Tensor) else dt


def discretize_foh(A, B, dt):
    """First-order-hold discretization via the augmented exponential,

        expm([[A, B, 0], [0, 0, I], [0, 0, 0]] dt) -> Ad, P, Q,

    so that x_{k+1} = Ad x_k + P u_k + Q (u_{k+1} - u_k) / dt (python-
    control's `forced_response` with linearly interpolated inputs). With
    a constant input the Q term vanishes and (Ad, P) is the ZOH pair.
    A [..., n, n], B [..., n] or [..., n, m], dt a number or [...];
    returns [..., n, n], [..., n, m], [..., n, m]."""
    n = A.shape[-1]
    B = B[..., None] if B.ndim == A.ndim - 1 else B
    m = B.shape[-1]
    h = _dt(dt)
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    e = _augmented_expm(
        [(slice(0, n), slice(0, n), A * h),
         (slice(0, n), slice(n, n + m), B * h),
         (slice(n, n + m), slice(n + m, n + 2 * m),
          (eye * h).expand(A.shape[:-2] + (m, m)))],
        n + 2 * m, A)
    return e[..., :n, :n], e[..., :n, n:n + m], e[..., :n, n + m:]


def discretize_zoh(A, B, dt):
    """Exact zero-order-hold discretization via the augmented exponential,
    expm([[A, B], [0, 0]] dt) = [[Ad, Bd], [0, I]] (what
    `ct.forced_response` computes over one sample with a constant input,
    reference vehicle.py:1835-1842). Shapes as `discretize_foh`."""
    n = A.shape[-1]
    B = B[..., None] if B.ndim == A.ndim - 1 else B
    m = B.shape[-1]
    h = _dt(dt)
    e = _augmented_expm([(slice(0, n), slice(0, n), A * h),
                         (slice(0, n), slice(n, n + m), B * h)], n + m, A)
    return e[..., :n, :n], e[..., :n, n:]


def matrix_power(A, k: int):
    """A^k [..., n, n] by square-and-multiply; k is a static Python int."""
    n = A.shape[-1]
    result = torch.eye(n, dtype=A.dtype, device=A.device).expand(
        A.shape).contiguous()
    base = A
    while k > 0:
        if k & 1:
            result = matmul_small(result, base)
        k >>= 1
        if k:
            base = matmul_small(base, base)
    return result
