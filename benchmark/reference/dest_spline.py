"""The spline (path-planning) destination force of upstream
cyclistsocialforce's `TwoDBicycle.calcDestinationForce` (v2.1.1,
vehicle.py:1416-1558), the BMD2023 "2D model", in plain PyTorch for any
float dtype. Nothing here imports the program or JAX.

Each step, for each rider:

- the destination queue and the navigation FSM are updated (`navigate`);
- at the rider's first step the force pushes along its heading at the
  desired speed, and once the FSM has latched "arrived" it is zero;
- otherwise a parametric cubic is fitted through support points: where
  the current destination is not the queue's last, the previous
  position, the current one and the queue's destinations from the
  current one on, at most 4; at the last destination, the position 1 s
  back (floor(1 / t_s) steps, or the episode's first position while the
  episode is younger), the position one step back, the current one and
  the destination. The fit interpolates every point at its normalised
  cumulative chord length (scipy's `splprep(s=0)`: the not-a-knot cubic);
- it is sampled at 20 uniform parameters. The rider's sample is the
  nearest of them to its position at the last destination, else the
  second; the look-ahead sample lies 3 further on (5 for a stop
  destination);
- the force points from the rider's sample to the look-ahead sample, at
  the desired speed, but no faster than the curvature at the rider's
  sample allows a ~10 degree lean: v = sqrt(theta_comf g R), at least
  2.5 m/s;
- where the look-ahead lies past the last sample, or the fit has no
  finite answer (two support points in one place), the force is the
  straight line after a second pass of the queue update and the FSM (as
  upstream, which calls them again before its straight-line force).

Departures from upstream: the fit is the textbook one (second
derivatives from the m x m not-a-knot system, solved densely by Gaussian
elimination with partial pivoting, written out so that it runs in any
dtype) and not FITPACK's B-spline fit, which gives the same cubic up to
rounding; upstream keeps the positions in a list of its own, here the
ring of the state (`pos_hist`, `t_glob`); a fit upstream's splprep
refuses (repeated points) falls back as any non-finite fit does.
"""

from __future__ import annotations

import math

import torch

from . import step as R

N_FWD = 4                       # forward destinations in a not-last fit
N_SAMPLES = 20                  # uniform samples of the fitted spline
AHEAD, AHEAD_STOP = 3, 5        # look-ahead samples (stop destination)
THETA_COMF = math.radians(10.0)  # comfortable lean
V_MIN = 2.5                     # least curvature-limited speed, m/s


def solve(A, b):
    """x with A x = b for a batch of small dense systems, A [n, m, m], b
    [n, m, k]: Gaussian elimination with partial pivoting."""
    A, b = A.clone(), b.clone()
    n, m, _ = A.shape
    rows = torch.arange(n, device=A.device)
    for k in range(m):
        piv = k + torch.argmax(A[:, k:, k].abs(), dim=1)
        for t in (A, b):
            top, low = t[rows, k].clone(), t[rows, piv].clone()
            t[rows, k] = low
            t[rows, piv] = top
        f = A[:, k + 1:, k] / A[:, k, k, None]
        A[:, k + 1:] -= f[:, :, None] * A[:, k, None]
        b[:, k + 1:] -= f[:, :, None] * b[:, k, None]
    x = torch.zeros_like(b)
    for k in range(m - 1, -1, -1):
        acc = b[:, k] - torch.einsum("nj,njd->nd", A[:, k, k + 1:],
                                     x[:, k + 1:])
        x[:, k] = acc / A[:, k, k, None]
    return x


def fit(pts):
    """The not-a-knot cubic through pts [n, m, 2] (m >= 4) at the
    normalised cumulative chord lengths: (sites t [n, m], second
    derivatives M [n, m, 2])."""
    n, m, _ = pts.shape
    seg = torch.sqrt(((pts[:, 1:] - pts[:, :-1]) ** 2).sum(-1))
    cum = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, 1)], 1)
    t = cum / cum[:, -1:]
    h = t[:, 1:] - t[:, :-1]
    slope = (pts[:, 1:] - pts[:, :-1]) / h[:, :, None]
    A = torch.zeros((n, m, m), dtype=pts.dtype, device=pts.device)
    rhs = torch.zeros((n, m, 2), dtype=pts.dtype, device=pts.device)
    # the third derivative continuous across the second and the
    # next-to-last sites (not-a-knot)
    for r, j in ((0, 0), (m - 1, m - 3)):
        A[:, r, j] = 1.0 / h[:, j]
        A[:, r, j + 1] = -(1.0 / h[:, j] + 1.0 / h[:, j + 1])
        A[:, r, j + 2] = 1.0 / h[:, j + 1]
    # the second derivative continuous across each interior site
    for i in range(1, m - 1):
        A[:, i, i - 1] = h[:, i - 1] / 6.0
        A[:, i, i] = (h[:, i - 1] + h[:, i]) / 3.0
        A[:, i, i + 1] = h[:, i] / 6.0
        rhs[:, i] = slope[:, i] - slope[:, i - 1]
    return t, solve(A, rhs)


def evaluate(t, pts, M, q):
    """The cubic and its first two derivatives at parameters q [Q]:
    (S, dS, d2S), each [n, Q, 2]. A parameter at a site takes the
    interval that ends there."""
    m = t.shape[1]
    k = torch.clamp((q[None, :, None] > t[:, None, :]).sum(-1) - 1, 0, m - 2)

    def at(v, j):
        idx = j.reshape(j.shape + (1,) * (v.ndim - 2))
        return torch.gather(v, 1, idx.expand((-1, -1) + v.shape[2:]))

    t0, t1 = at(t, k)[..., None], at(t, k + 1)[..., None]
    y0, y1, M0, M1 = at(pts, k), at(pts, k + 1), at(M, k), at(M, k + 1)
    h = t1 - t0
    a, b = t1 - q[None, :, None], q[None, :, None] - t0
    S = ((M0 * a ** 3 + M1 * b ** 3) / (6.0 * h)
         + (y0 / h - M0 * h / 6.0) * a + (y1 / h - M1 * h / 6.0) * b)
    dS = ((M1 * b ** 2 - M0 * a ** 2) / (2.0 * h)
          + (y1 - y0) / h - (M1 - M0) * h / 6.0)
    d2S = (M0 * a + M1 * b) / h
    return S, dS, d2S


def support_points(st: dict, upd: dict, lookback: int):
    """[N, 6, 2] support points of every rider's fit, of which the fit
    takes the first `count` [N]: 2 + the forward destinations (at most 4)
    where the destination is not the queue's last, else 4; and which
    riders are at the last."""
    pos = st["s"][:, :2]
    ring, t = st["pos_hist"], int(st["t_glob"])
    hist = ring.shape[1]
    prev = ring[:, (t - 1) % hist]
    back = ring[:, (t - min(t, lookback)) % hist]
    queue, nq, ptr = st["destqueue"], st["nq"], upd["destpointer"]
    last = ptr >= nq - 1
    idx = torch.clamp(ptr[:, None] + torch.arange(N_FWD, device=ptr.device),
                      max=queue.shape[1] - 1).long()
    ahead = torch.gather(queue[:, :, :2], 1, idx[:, :, None].expand(-1, -1, 2))
    count = torch.where(last, 4, 2 + torch.clamp(nq - ptr, max=N_FWD))
    fwd = torch.cat([prev[:, None], pos[:, None], ahead], 1)
    tail = upd["dest"][:, None, :2].expand(-1, 3, -1)
    pts = torch.where(last[:, None, None], torch.cat(
        [back[:, None], prev[:, None], pos[:, None], tail], 1), fwd)
    return pts, count, last


def spline_force(pts, count, last, pos, stop, vd, g):
    """The force along each rider's fitted spline and whether it has to
    fall back to the straight line (look-ahead past the end, or no finite
    fit)."""
    n = pts.shape[0]
    dtype, dev = pts.dtype, pts.device
    q = torch.arange(N_SAMPLES, dtype=dtype, device=dev) / (N_SAMPLES - 1)
    S = torch.zeros((n, N_SAMPLES, 2), dtype=dtype, device=dev)
    dS, d2S = torch.zeros_like(S), torch.zeros_like(S)
    for m in (4, 5, 6):
        rows = torch.nonzero(count == m).squeeze(1)
        if rows.numel():
            t, M = fit(pts[rows, :m])
            S[rows], dS[rows], d2S[rows] = evaluate(t, pts[rows, :m], M, q)
    d2 = ((S - pos[:, None, :]) ** 2).sum(-1)
    near = torch.where(last, torch.argmin(d2, dim=1), 1)
    ahead = near + torch.where(stop, AHEAD_STOP, AHEAD)
    r = torch.arange(n, device=dev)
    here, there = S[r, near], S[r, torch.clamp(ahead, max=N_SAMPLES - 1)]
    d1, dd = dS[r, near], d2S[r, near]
    radius = (torch.sqrt(d1[:, 0] ** 2 + d1[:, 1] ** 2) ** 3
              / torch.abs(d1[:, 0] * dd[:, 1] - d1[:, 1] * dd[:, 0]))
    v = torch.minimum(
        torch.clamp(torch.sqrt(THETA_COMF * g * radius), min=V_MIN), vd)
    seg = there - here
    length = torch.sqrt(seg[:, 0] ** 2 + seg[:, 1] ** 2)
    f = v[:, None] * seg / torch.where(length > 0, length, 1.0)[:, None]
    fall_back = (ahead >= N_SAMPLES) | ~torch.isfinite(f).all(1)
    return f[:, 0], f[:, 1], fall_back


def destination(st: dict, p: dict):
    """The spline destination force: (fx, fy, the updated dest,
    destpointer, znav and znavparams)."""
    s, i = st["s"], st["i"]
    vd, _, upd = R.navigate(st, p)
    pts, count, last = support_points(st, upd, int(math.floor(1.0 / p["t_s"])))
    fx, fy, fall_back = spline_force(pts, count, last, s[:, :2],
                                     upd["dest"][:, 2] > 0, vd, p["g"])
    arrived = upd["znav"][:, 2]
    first = i == 0
    fx = torch.where(first, vd * torch.cos(s[:, 2]),
                     torch.where(arrived, 0.0, fx))
    fy = torch.where(first, vd * torch.sin(s[:, 2]),
                     torch.where(arrived, 0.0, fy))
    fall_back = fall_back & ~arrived & ~first
    # the second pass of the queue update and the FSM, then the straight
    # line, where the spline falls back
    fbx, fby, upd2 = R.destination({**st, **upd}, p)
    for key, val in upd2.items():
        mask = fall_back.reshape((-1,) + (1,) * (val.ndim - 1))
        upd[key] = torch.where(mask, val, upd[key])
    return (torch.where(fall_back, fbx, fx), torch.where(fall_back, fby, fy),
            upd)
