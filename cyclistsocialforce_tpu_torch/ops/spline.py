"""Parametric interpolating cubic splines of fixed size, batched over a
leading agent axis.

Counterpart of `cyclistsocialforce_tpu.ops.spline`, which vmaps one
agent's fit; here every function takes the agent axis in front ([..., m,
d] points, [...] valid counts). The reference fits the path-planning
spline with `scipy.interpolate.splprep(s=0)` every step (reference
vehicle.py:1495-1510): the not-a-knot interpolating cubic over the
normalized cumulative chord parameter, which for m points is an m x m
linear system in the second derivatives ("moments"). The operations are
the JAX module's, in its order, so a degenerate fit (duplicate support
points) gives non-finite moments exactly where the JAX one does: the
engine sends such agents to the straight-line fallback.
"""

from __future__ import annotations

import torch

from cyclistsocialforce_tpu_torch.ops.smallmat import solve_small


def chord_param(pts):
    """Normalized cumulative chord-length parameter u in [0, 1] of pts
    [..., m, d]: [..., m]."""
    seg = torch.sqrt(torch.sum(torch.diff(pts, dim=-2) ** 2, dim=-1))
    u = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, -1)],
                  dim=-1)
    return u / u[..., -1:]


def notaknot_moments(t, y):
    """Second derivatives M [..., m, d] of the not-a-knot interpolating
    cubic through values y [..., m, d] at strictly increasing sites t
    [..., m] (m static, >= 4)."""
    m = t.shape[-1]
    h = torch.diff(t, dim=-1)                             # [..., m-1]
    zero = torch.zeros_like(t[..., 0])

    def row(entries):                                     # {col: [...]}
        return torch.stack([entries.get(j, zero) for j in range(m)], dim=-1)

    def hh(i):
        return h[..., i]

    rows = [row({0: 1.0 / hh(0),                          # not-a-knot at t[1]
                 1: -(1.0 / hh(0) + 1.0 / hh(1)),
                 2: 1.0 / hh(1)})]
    for i in range(1, m - 1):                             # C2 at interior sites
        rows.append(row({i - 1: hh(i - 1) / 6.0,
                         i: (hh(i - 1) + hh(i)) / 3.0,
                         i + 1: hh(i) / 6.0}))
    rows.append(row({m - 3: 1.0 / hh(m - 3),              # not-a-knot at t[m-2]
                     m - 2: -(1.0 / hh(m - 3) + 1.0 / hh(m - 2)),
                     m - 1: 1.0 / hh(m - 2)}))
    A = torch.stack(rows, dim=-2)

    zrow = torch.zeros_like(y[..., 0, :])
    rhs = torch.stack(
        [zrow] + [(y[..., i + 1, :] - y[..., i, :]) / h[..., i, None]
                  - (y[..., i, :] - y[..., i - 1, :]) / h[..., i - 1, None]
                  for i in range(1, m - 1)] + [zrow], dim=-2)
    # no pivoting: the moment system eliminates stably in order for valid
    # chord parameters; duplicate points give non-finite values either way
    return solve_small(A, rhs, pivot=False)


def _masked_sites(pts6, m):
    """Chord sites t [..., 6] of a fit over the first m[...] of the 6
    points (padded sites continue increasing past 1, so the interval
    search never selects them) and the interval widths h [..., 5]."""
    idx = torch.arange(6, device=pts6.device)
    mm = m[..., None]
    seg = torch.sqrt(torch.sum(torch.diff(pts6, dim=-2) ** 2, dim=-1))
    seg = torch.where(idx[:5] < mm - 1, seg, 0.0)
    cum = torch.cumsum(seg, dim=-1)
    total = cum[..., -1:]                   # = chord length of the valid run
    u = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1) / total
    t = torch.where(idx < mm, u, (idx - mm + 2).to(pts6.dtype))
    return t, torch.diff(t, dim=-1)


def _interval_pieces(t, y, M, q):
    """The interval of each query q [..., Q] (or [Q]) and its pieces, by
    comparisons and one one-hot contraction over a side table. STRICT
    inequality: a query exactly at a site evaluates the interval ending
    there, so the last valid site t = 1 of a masked fit never selects the
    padding interval beyond it. Returns (hk [..., Q, 1], t1, t2, Mk, Mk1,
    yk, yk1)."""
    m = t.shape[-1]
    d = y.shape[-1]
    h = torch.diff(t, dim=-1)
    k = torch.clamp(torch.sum(q[..., :, None] > t[..., None, :], dim=-1) - 1,
                    0, m - 2)                                       # [..., Q]
    oh = (k[..., None] == torch.arange(m - 1, device=t.device)).to(t.dtype)
    table = torch.cat(
        [h[..., None], t[..., 1:, None], t[..., :-1, None],
         M[..., :-1, :], M[..., 1:, :], y[..., :-1, :], y[..., 1:, :]],
        dim=-1)                                           # [..., m-1, 3 + 4d]
    sel = torch.sum(oh[..., :, :, None] * table[..., None, :, :], dim=-2)
    hk = sel[..., 0:1]
    t1 = sel[..., 1:2] - q[..., :, None]                  # to the right site
    t2 = q[..., :, None] - sel[..., 2:3]
    Mk, Mk1 = sel[..., 3:3 + d], sel[..., 3 + d:3 + 2 * d]
    yk, yk1 = sel[..., 3 + 2 * d:3 + 3 * d], sel[..., 3 + 3 * d:3 + 4 * d]
    return hk, t1, t2, Mk, Mk1, yk, yk1


def spline_eval(t, y, M, q):
    """The cubic (sites t [..., m], values y [..., m, d], moments M) and
    its first two derivatives at queries q [..., Q]: (S, dS, d2S), each
    [..., Q, d]."""
    hk, t1, t2, Mk, Mk1, yk, yk1 = _interval_pieces(t, y, M, q)
    a = yk / hk - Mk * hk / 6.0
    b = yk1 / hk - Mk1 * hk / 6.0
    S = (Mk * t1**3 + Mk1 * t2**3) / (6.0 * hk) + a * t1 + b * t2
    dS = (-Mk * t1**2 + Mk1 * t2**2) / (2.0 * hk) - a + b
    d2S = (Mk * t1 + Mk1 * t2) / hk
    return S, dS, d2S


def eval_positions(t, y, M, q):
    """Positions S [..., Q, d] only: the nearest-sample search's pass."""
    hk, t1, t2, Mk, Mk1, yk, yk1 = _interval_pieces(t, y, M, q)
    a = yk / hk - Mk * hk / 6.0
    b = yk1 / hk - Mk1 * hk / 6.0
    return (Mk * t1**3 + Mk1 * t2**3) / (6.0 * hk) + a * t1 + b * t2


def fit_masked(pts6, m):
    """Not-a-knot fit over a fixed [..., 6, 2] point array with a runtime
    valid count m [...] in {4, 5, 6} (rows >= m ignored), as one masked 6 x
    6 system: row 0 the not-a-knot condition at t[1]; row i in 1..5 the C2
    condition if i <= m - 2, the second not-a-knot row if i == m - 1, the
    identity (M_i = 0) if i >= m. Padded rows must be finite. Returns (t
    [..., 6], M [..., 6, 2]) for `spline_eval`."""
    dtype = pts6.dtype
    idx = torch.arange(6, device=pts6.device)
    mm = m[..., None]
    t, h = _masked_sites(pts6, m)

    inv_h = 1.0 / h
    zero6 = torch.zeros_like(t)

    def e(i, val):
        return torch.where(idx == i, val[..., None], 0.0)

    def hv(v, i):
        return v[..., i]

    rows = [e(0, hv(inv_h, 0)) + e(1, -(hv(inv_h, 0) + hv(inv_h, 1)))
            + e(2, hv(inv_h, 1))]
    for i in range(1, 6):
        interior = (e(i - 1, hv(h, i - 1) / 6.0)
                    + e(i, (hv(h, i - 1) + hv(h, i % 5)) / 3.0)
                    + e(i + 1, hv(h, i % 5) / 6.0)) if i < 5 else zero6
        nak = (e(i - 2, hv(inv_h, i - 2))
               + e(i - 1, -(hv(inv_h, i - 2) + hv(inv_h, i - 1)))
               + e(i, hv(inv_h, i - 1)))
        ident = torch.where(idx == i, 1.0, zero6)
        rows.append(torch.where(i <= mm - 2, interior,
                                torch.where(i == mm - 1, nak, ident)))
    A = torch.stack(rows, dim=-2)                                # [..., 6, 6]

    dd = ((pts6[..., 2:, :] - pts6[..., 1:-1, :]) / h[..., 1:, None]
          - (pts6[..., 1:-1, :] - pts6[..., :-2, :]) / h[..., :-1, None])
    interior_mask = (idx[1:5] <= mm - 2)[..., None]
    zrow = torch.zeros_like(pts6[..., :1, :])
    rhs = torch.cat([zrow, torch.where(interior_mask, dd, 0.0), zrow],
                    dim=-2)                                      # [..., 6, 2]
    M = solve_small(A, rhs.to(dtype), pivot=False)
    return t, M


def fit_masked_banded(pts6, m):
    """`fit_masked` through the system's banded structure: the end moments
    M[0] = p1 M[1] + p2 M[2] and M[m-1] = q1 M[m-2] + q2 M[m-3] from the two
    not-a-knot rows fold into the first and last live interior rows, and
    an unrolled Thomas sweep solves the <= 4 interior moments (slot i live
    when i <= m - 3). Same returns and degeneracy as `fit_masked`."""
    idx = torch.arange(6, device=pts6.device)
    mm = m[..., None]
    t, h = _masked_sites(pts6, m)

    def hv(i):
        return h[..., i]

    # end-moment relations from the two not-a-knot rows
    p1 = (hv(0) + hv(1)) / hv(1)
    p2 = -hv(0) / hv(1)

    def at(v, k):                        # one-hot take from a [..., 5] vector
        return torch.sum(torch.where(
            torch.arange(5, device=v.device) == k[..., None], v, 0.0), dim=-1)

    h_m3 = at(h, m - 3)
    h_m2 = at(h, m - 2)
    q1 = (h_m3 + h_m2) / h_m3            # coefficient of M[m-2]
    q2 = -h_m2 / h_m3                    # coefficient of M[m-3]

    dd = ((pts6[..., 2:, :] - pts6[..., 1:-1, :]) / h[..., 1:, None]
          - (pts6[..., 1:-1, :] - pts6[..., :-2, :]) / h[..., :-1, None])

    live = idx[:4] <= mm - 3                                       # [..., 4]
    a = torch.where(live, h[..., :4] / 6.0, 0.0)         # sub-diagonal
    b = torch.where(live, (h[..., :4] + h[..., 1:5]) / 3.0, 1.0)
    c = torch.where(live, h[..., 1:5] / 6.0, 0.0)        # super-diagonal
    d = torch.where(live[..., None], dd, 0.0)

    # fold the end relations into the first and last live rows
    is_last = idx[:4] == mm - 3
    a0 = a[..., 0:1]
    b = torch.cat([b[..., :1] + a0 * p1[..., None], b[..., 1:]], dim=-1)
    c = torch.cat([c[..., :1] + a0 * p2[..., None], c[..., 1:]], dim=-1)
    b = b + torch.where(is_last, c * q1[..., None], 0.0)
    a = a + torch.where(is_last, c * q2[..., None], 0.0)
    c = torch.where(is_last, 0.0, c)
    a = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], dim=-1)

    def s(v, i):
        return v[..., i]

    def r(i):
        return d[..., i, :]

    # unrolled Thomas sweep over the 4 slots (dead slots are identity)
    cp0 = s(c, 0) / s(b, 0)
    dp0 = r(0) / s(b, 0)[..., None]
    cp1 = s(c, 1) / (s(b, 1) - s(a, 1) * cp0)
    dp1 = ((r(1) - s(a, 1)[..., None] * dp0)
           / (s(b, 1) - s(a, 1) * cp0)[..., None])
    cp2 = s(c, 2) / (s(b, 2) - s(a, 2) * cp1)
    dp2 = ((r(2) - s(a, 2)[..., None] * dp1)
           / (s(b, 2) - s(a, 2) * cp1)[..., None])
    dp3 = ((r(3) - s(a, 3)[..., None] * dp2)
           / (s(b, 3) - s(a, 3) * cp2)[..., None])
    m3 = dp3
    m2 = dp2 - cp2[..., None] * m3
    m1 = dp1 - cp1[..., None] * m2
    m0 = dp0 - cp0[..., None] * m1
    Mi = torch.stack([m0, m1, m2, m3], dim=-2)                  # [..., 4, 2]
    Mi = torch.where(live[..., None], Mi, 0.0)

    zrow = torch.zeros_like(Mi[..., :1, :])
    M = torch.cat([zrow, Mi, zrow], dim=-2)
    M0 = p1[..., None] * M[..., 1, :] + p2[..., None] * M[..., 2, :]
    M = torch.cat([M0[..., None, :], M[..., 1:, :]], dim=-2)
    # M[m-1] = q1 M[m-2] + q2 M[m-3] by one-hot selects
    M_m2 = torch.sum(torch.where((idx == mm - 2)[..., None], M, 0.0), dim=-2)
    M_m3 = torch.sum(torch.where((idx == mm - 3)[..., None], M, 0.0), dim=-2)
    M_end = q1[..., None] * M_m2 + q2[..., None] * M_m3
    M = torch.where((idx == mm - 1)[..., None], M_end[..., None, :], M)
    return t, M


def uniform_grid(n: int, dtype, device=None):
    """`n` uniform parameters on [0, 1] equal to `jnp.linspace(0, 1, n)`
    in `dtype`. JAX's linspace divides an integer range by n - 1, which
    XLA compiles (on the CPU, where the tests compare) to a product with
    the reciprocal 1 / (n - 1) rounded once in the dtype, and appends the
    endpoint 1 exactly; numpy's linspace gives the same values. So does
    this: the range times that reciprocal, then 1. (A true division, i /
    (n - 1) rounded once, misses by an ulp at some i: 13 and 17 of 20 in
    float64.)"""
    head = torch.arange(n - 1, dtype=dtype, device=device) * (1.0 / (n - 1))
    return torch.cat([head, torch.ones(1, dtype=dtype, device=device)])


def fit_eval_parametric(pts, n_eval: int = 20):
    """splprep(s=0) equivalent: fit the chord-parameterized interpolating
    spline through pts [..., m, 2] and evaluate it with two derivatives at
    `n_eval` uniform parameters (reference vehicle.py:1495-1510). Returns
    [..., n_eval, 6]: (x, y, dx, dy, d2x, d2y), the reference's
    `destspline` layout."""
    u = chord_param(pts)
    M = notaknot_moments(u, pts)
    q = uniform_grid(n_eval, pts.dtype, pts.device)
    S, dS, d2S = spline_eval(u, pts, M, q)
    return torch.cat([S, dS, d2S], dim=-1)
