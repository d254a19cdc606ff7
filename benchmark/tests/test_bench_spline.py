"""The reference's spline destination force (`reference/dest_spline.py`)
against the port's `engine.dest_force_spline` in float64 on the CPU, on
seeded states in which every branch is taken: a rider's first step,
"arrived", the not-last fit (2 to 4 forward destinations), the
last-destination fit (with and without a stop), and the straight-line
fallback (look-ahead past the spline's end, repeated support points).

Tolerance 1e-9 (forces in m/s, positions in m): the two fits solve the
same cubic in different ways (a dense pivoted elimination here, the
port's banded sweep there), so they differ by rounding, amplified by
the systems' conditioning: the support points lie 1-6 cm apart next to
points 20 m apart."""

import math

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import dest_spline
from benchmark.reference import step as R

N, H, Q = 256, 128, 16
TOL = 1e-9


def params():
    return harness.cell_files("twod-routes-100k")[1]["params"]


def make(seed: int, t_glob: int):
    """A float64 state of N riders: each with a route of 4 waypoints, a
    pointer anywhere on it, a ring of the last H positions along its
    heading, and rows made to take each branch."""
    from cyclistsocialforce_tpu_torch.state import make_state

    rng = np.random.default_rng(seed)
    s0 = np.zeros((N, 5))
    s0[:, :2] = rng.uniform(-100, 100, (N, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, N)
    s0[:, 3] = rng.uniform(1, 6, N)
    st = make_state(s0, Q, H, dtype=torch.float64, device="cpu")
    pos, psi, v = s0[:, :2], s0[:, 2], s0[:, 3]
    d = np.stack([np.cos(psi), np.sin(psi)], 1)
    # slot (t_glob - j) % H holds the position j steps back
    ring = np.zeros((N, H, 2))
    for j in range(H):
        ring[:, (t_glob - j) % H] = pos - j * 0.01 * v[:, None] * d
    ang = psi + rng.uniform(-1.5, 1.5, N)
    along = 20.0 * np.arange(1, 5)[None, :]
    side = rng.uniform(-5, 5, (N, 4))
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    queue = np.zeros((N, Q, 3))
    queue[:, :4, 0] = pos[:, :1] + along * c - side * s
    queue[:, :4, 1] = pos[:, 1:] + along * s + side * c
    ptr = rng.integers(0, 4, N)
    nq = np.full(N, 4)
    i = np.full(N, t_glob)
    znav = np.zeros((N, 3), bool)
    znav[:, 0] = True
    r = np.arange(N)
    # the last destination close ahead: the look-ahead passes the end
    near = r % 8 == 1
    ptr[near] = 3
    ahead = rng.uniform(0.2, 0.6, (near.sum(), 1))
    queue[near, 3, :2] = pos[near] + ahead * d[near]
    # a stop at the last destination (look-ahead 5)
    stop = r % 8 == 2
    ptr[stop] = 3
    queue[stop, 3, 2] = 1.0
    # arrived: latched at a stop destination
    arrived = r % 8 == 3
    ptr[arrived] = 3
    queue[arrived, 3, 2] = 1.0
    znav[arrived] = [False, False, True]
    # standing still: the ring's last positions repeat
    still = r % 8 == 4
    ring[still] = pos[still][:, None, :]
    # a rider's first step
    i[r % 8 == 5] = 0
    # within 2 m of the current waypoint: the pointer advances
    adv = (r % 8 == 6) & (ptr < 3)
    queue[adv, ptr[adv], :2] = pos[adv] + 1.5 * d[adv]
    dest = queue[r, ptr]

    def t(x, dt=torch.float64):
        return torch.as_tensor(x, dtype=dt)

    return st.replace(
        pos_hist=t(ring), t_glob=torch.tensor(t_glob, dtype=torch.int32),
        destqueue=t(queue), dest=t(dest), destpointer=t(ptr, torch.int32),
        nq=t(nq, torch.int32), i=t(i, torch.int32), znav=t(znav, torch.bool))


@pytest.mark.parametrize("t_glob", [150, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_spline_force_matches_the_port(seed, t_glob):
    from cyclistsocialforce_tpu_torch.engine import dest_force_spline
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    p = params()
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in p.items()}
    st = make(seed, t_glob)
    fx, fy, prog = dest_force_spline(BicycleParams.create(**kw), st)
    ref_st = harness.reference_input(st, torch.float64, "twod")
    rx, ry, upd = dest_spline.destination(ref_st, p)
    assert float((fx - rx).abs().max()) < TOL
    assert float((fy - ry).abs().max()) < TOL
    for key in ("dest", "znavparams"):
        assert float((getattr(prog, key) - upd[key]).abs().max()) < TOL
    for key in ("destpointer", "znav"):
        assert torch.equal(getattr(prog, key), upd[key])

    # every branch is taken
    vd, _, first = R.navigate(ref_st, p)
    pts, count, last = dest_spline.support_points(
        ref_st, first, int(math.floor(1.0 / p["t_s"])))
    _, _, fall_back = dest_spline.spline_force(
        pts, count, last, ref_st["s"][:, :2], first["dest"][:, 2] > 0, vd,
        p["g"])
    live = (ref_st["i"] > 0) & ~first["znav"][:, 2]
    assert int((ref_st["i"] == 0).sum()) > 0
    assert int(first["znav"][:, 2].sum()) > 0
    for m in (4, 5, 6):
        assert int((live & ~last & (count == m)).sum()) > 0
    assert int((live & last & ~fall_back).sum()) > 0
    assert int((live & last & (first["dest"][:, 2] > 0)).sum()) > 0
    assert int((live & fall_back & last).sum()) > 0
    assert int((live & fall_back & ~last).sum()) > 0
