"""PyTorch port: the three pair kernels (K1 `csrc/pair_forces.cu`, K2
`csrc/pair_forces_unrolled.cu`, K3 `csrc/pair_forces_db.cu`) held to their
plain version on pairs placed at the discontinuities of the pair field,
where one rounding step decides a whole pair force: exactly on a receiver's FOV cone edge
(and up to 3 ulps either side), straight ahead of a source (|sin phi| of
0 to ~2e-6, the sign(sin phi) jump, with and without the
priority-to-the-right edge),
coincident (rho2 = 0), with sigma <= 0 (one such pair ~1e-9 m apart
near the origin, where sigma^2 times the squared distance underflows
float32), with zero amplitude, at the distance screen's cutoff (exactly,
and one ulp beyond), and at inactive receivers. The kernels share one
per-pair math (`csrc/pair_math.cuh`), which rounds the operations that
decide these (its decision chain) as the plain version does and fuses the
smooth rest, so every force must agree within the kernels' float32 bar in
every form of every kernel. The plain version itself is held to the JAX
package's Pallas kernels (interpret mode) on the same inputs, so the
chain JAX -> plain -> CUDA kernel is closed on the edges.

The inputs are built with numpy from a seed. The card's tests skip
without a CUDA device (and need no JAX):
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_k1_edges.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402

torch.set_num_threads(1)

# the JAX package's float32 bar for its Pallas kernels (tests/
# test_neighbors.py): |kernel - plain| <= ATOL + RTOL |plain|
ATOL, RTOL = 1e-4, 2e-4
BLOCK, BLOCK_SRC = 128, 64
N_RECV_BLOCKS, N_SRC_BLOCKS = 4, 8
HFOV = 2 * math.pi / 3
CUTOFF = 20.0                       # the screened forms' cutoff
CLUSTER_STEP = 60.0                 # receiver blocks' clusters this far apart
# BicycleParams' twod defaults (e_0, e_1, sigma_0..3) and f_0; rows of the
# sigma <= 0 kind take SIGMA_NEG (sigma_2 > sigma_0, sigma_3 > sigma_1:
# sigma < 0 behind the source)
TWOD = (0.995, 0.7, 0.5, 5.0, 0.3, 4.9)
SIGMA_NEG = (0.2, 1.0, 0.5, 3.0)
F0 = 7.0
UNIFORM = (*TWOD, math.cos(HFOV / 2))
# legacy rows (mixed form): amp, e, 1/sqrt(1 - e^2), 1/p_decay
LEGACY_E, LEGACY_AMP, LEGACY_INV_PD = 0.6, 2.0, 0.25

# source kinds, by row index mod 8 (tiles 0-6; tile 7 is the screen edge)
CONE_LEFT, CONE_RIGHT, AHEAD_P2R_EDGE, AHEAD, COINCIDENT, SIGMA_LE_0, \
    SILENT, NEAR = range(8)
# the sigma <= 0 row placed 8 ulps (~9.3e-10 m) ahead of its receiver at
# (2^-10, 2^-10) m, the receiver straight behind it and facing it
TINY_ROW, TINY_AT = 8 * 20 + SIGMA_LE_0, 2.0 ** -10
# the kinds whose pair sits on a discontinuity of the field
EDGE_KINDS = (CONE_LEFT, CONE_RIGHT, AHEAD_P2R_EDGE, AHEAD)


def _grid(a):
    """float32 on a 1/64 m grid, so that sums of two positions are exact."""
    return (np.round(np.asarray(a, np.float64) * 64) / 64).astype(np.float32)


def cone_dot_ulps(x, y, r):
    """For sources at float32 (x, y): the plain version's cone test value
    dxn cr + dyn sr at receiver `r` = (x, y, cos, sin), minus its bound
    -cos(hfov/2), in float32 ulps of the bound (numpy float32 in the plain
    version's operation order, the rsqrt as 1 / sqrt)."""
    dx = r[0] - x
    dy = r[1] - y
    rho2 = dx * dx + dy * dy
    inv = np.float32(1) / np.sqrt(np.maximum(rho2, np.float32(1e-30)))
    dot = (dx * inv) * r[2] + (dy * inv) * r[3]
    bound = np.float32(-math.cos(HFOV / 2))
    return (dot - bound) / np.spacing(np.abs(bound))


def sin_phi(x, y, c, s, r):
    """sin(phi) of sources at float32 (x, y) with heading (c, s) at
    receiver `r`, in the plain version's operation order (numpy
    float32)."""
    dx = r[0] - x
    dy = r[1] - y
    rho2 = dx * dx + dy * dy
    inv = np.float32(1) / np.sqrt(np.maximum(rho2, np.float32(1e-30)))
    return (dy * inv) * c - (dx * inv) * s


def place(p, value, want):
    """The float32 position within 24 ulps in x and y of float64 point `p`
    at which `value(x, y)` lies nearest `want`."""
    k = np.arange(-24, 25, dtype=np.float32)
    x0, y0 = np.float32(p[0]), np.float32(p[1])
    xs = x0 + k * np.spacing(np.abs(x0))
    ys = y0 + k * np.spacing(np.abs(y0))
    X, Y = np.meshgrid(xs, ys)
    i = np.argmin(np.abs(value(X, Y) - want))
    return X.flat[i], Y.flat[i]


def edge_inputs(seed=0, mixed=False):
    """(nbr, valid, src_pack, recv_pack) numpy arrays and the index of
    each source's target receiver (-1: none).

    Receiver block b is a cluster in a 30 m square centred at
    (CLUSTER_STEP (b - 1.5), 0); its table lists all 8 source blocks
    (block 2's only the first 5, a short valid prefix). Source row
    j < 448 is placed against receiver j by its kind (j mod 8); every
    other receiver sees it as an ordinary pair. Tile 7 is the screen
    edge: receivers 448-511 sit at one point P outside their cluster's
    square, and the tile's rows 0-31 lie exactly CUTOFF from P, rows 32-63
    one float32 ulp beyond, so the strip screen (sub 32) admits the first
    strip and skips the second.
    With `mixed`, odd rows are legacy rows (family 1)."""
    rng = np.random.default_rng(seed)
    n_recv, n_src = N_RECV_BLOCKS * BLOCK, N_SRC_BLOCKS * BLOCK_SRC
    centre = np.stack([CLUSTER_STEP * (np.arange(n_recv) // BLOCK - 1.5),
                       np.zeros(n_recv)], 1)
    rpos = _grid(centre + rng.uniform(-15, 15, (n_recv, 2)))
    p_edge = _grid(centre[448] + np.array([20.0, 20.0]))
    rpos[448:] = p_edge
    rpsi = rng.uniform(-np.pi, np.pi, n_recv)
    rc, rs = np.cos(rpsi).astype(np.float32), np.sin(rpsi).astype(np.float32)
    act = np.ones(n_recv, np.float32)
    act[::13] = 0.0

    spos = np.zeros((n_src, 2), np.float32)
    spsi = rng.uniform(-np.pi, np.pi, n_src)
    cols = np.tile(np.array(TWOD, np.float32), (n_src, 1))
    amp = np.full(n_src, F0, np.float32)
    target = np.full(n_src, -1)
    for j in range(448):
        kind, r = j % 8, j
        target[j] = r
        d = rng.uniform(0.5, 3.0)
        if kind in (CONE_LEFT, CONE_RIGHT):
            # the source direction from the receiver at +-hfov/2 from its
            # heading, placed -3..3 ulps of the bound from the cone's edge
            a = rpsi[r] + (HFOV / 2 if kind == CONE_LEFT else -HFOV / 2)
            p = rpos[r].astype(np.float64) + d * np.array([np.cos(a),
                                                            np.sin(a)])
            rr = (rpos[r, 0], rpos[r, 1], rc[r], rs[r])
            spos[j] = place(p, lambda x, y: cone_dot_ulps(x, y, rr),
                            (j // 8) % 7 - 3)
        elif kind in (AHEAD_P2R_EDGE, AHEAD):
            # the receiver straight ahead of the source, facing it (exactly,
            # or turned by up to 0.3 rad), at sin(phi) nearest one of 0,
            # +-1e-7, +-5e-7, +-2e-6
            turn = 0.0 if kind == AHEAD_P2R_EDGE else rng.uniform(-0.3, 0.3)
            spsi[j] = rpsi[r] + np.pi + turn
            c, sn = np.float32(np.cos(spsi[j])), np.float32(np.sin(spsi[j]))
            want = rng.choice([0.0, 1e-7, -1e-7, 5e-7, -5e-7, 2e-6, -2e-6])
            rr = (rpos[r, 0], rpos[r, 1])
            spos[j] = place(rpos[r] - d * np.array([c, sn], np.float64),
                            lambda x, y: sin_phi(x, y, c, sn, rr), want)
        elif kind == COINCIDENT:
            spos[j] = rpos[r]
        else:
            spos[j] = rpos[r] + rng.uniform(-3, 3, 2)
            if kind == SIGMA_LE_0:
                cols[j, 2:] = SIGMA_NEG
            elif kind == SILENT:
                amp[j] = 0.0
    # the tiny pair: sigma = -0.3 straight behind the source; its q sigma^2
    # (~1e-50) underflows float32, the plain version's P is 0
    rpos[TINY_ROW] = TINY_AT
    rc[TINY_ROW], rs[TINY_ROW] = 1.0, 0.0
    spsi[TINY_ROW] = 0.0
    spos[TINY_ROW] = (np.float32(TINY_AT)
                      + 8 * np.spacing(np.float32(TINY_AT)), TINY_AT)
    # tile 7: the screen edge, exactly CUTOFF from P, then one ulp beyond
    x_at = np.float32(p_edge[0] + np.float32(CUTOFF))
    spos[448:480] = (x_at, p_edge[1])
    spos[480:512] = (np.nextafter(x_at, np.float32(np.inf)), p_edge[1])

    src = np.zeros((n_src, PF.SRC_COLS), np.float32)
    src[:, 0:2] = spos
    src[:, 2], src[:, 3] = np.cos(spsi), np.sin(spsi)
    src[:, 4] = amp
    src[:, 5:11] = cols
    src[:, 11] = math.cos(HFOV / 2)
    src[:, 12] = 1.0
    src[:, 15] = 1.0
    if mixed:
        leg = np.arange(n_src) % 2 == 1
        src[leg, 4] = np.where(amp[leg] > 0, LEGACY_AMP, 0.0)
        src[leg, 5] = LEGACY_E
        src[leg, 6] = 1 / math.sqrt(1 - LEGACY_E ** 2)
        src[leg, 7] = LEGACY_INV_PD
        src[leg, 8:11] = 0.0
        src[leg, 13] = 1.0
    recv = np.zeros((PF.RECV_ROWS, n_recv), np.float32)
    recv[0], recv[1] = rpos[:, 0], rpos[:, 1]
    recv[2], recv[3], recv[4] = rc, rs, act
    nbr = np.tile(np.arange(N_SRC_BLOCKS, dtype=np.int32), (N_RECV_BLOCKS, 1))
    valid = np.ones(nbr.shape, bool)
    valid[2, 5:] = False
    return nbr, valid, src, recv, target


# K3's inputs (`edge_inputs_db`): blocks of 128 sources, the tile screen
# always on; the tile of the screen-edge rows is admitted at CUTOFF (32 of
# its rows lie exactly at it) and skipped at the float32 just below
DB_BLOCK_SRC = 128
CUTOFF_BELOW = float(np.nextafter(np.float32(CUTOFF), np.float32(0)))
FAR = 1.0e4                         # pad rows: silent, far from everything


def edge_inputs_db(seed=0, mixed=False):
    """`edge_inputs` rebuilt at block_src 128, as K3 takes it: (nbr,
    valid, src_pack, recv_pack, target) with the same receivers and five
    source tiles. Tiles 0-2 are rows 0-383 as they are; tile 3 is rows
    384-447 and 64 pad rows (silent, FAR away); tile 4 is the screen edge
    alone: the 32 rows exactly CUTOFF from the point P of receivers
    448-511, the 32 rows one ulp beyond, and 64 more copies of those. No
    other receiver of block 3 is within CUTOFF of tile 4, so its edge rows
    decide whether the tile screen admits it: at CUTOFF it does, at
    CUTOFF_BELOW it does not. Block 2's table is the short prefix of 3."""
    _, _, src, recv, target = edge_inputs(seed, mixed)
    pad = src[480:512].repeat(2, axis=0)            # any rows: overwritten
    pad[:, 0:2] = FAR
    pad[:, 4] = 0.0
    src = np.concatenate([src[:448], pad, src[448:512],
                          src[480:512].repeat(2, axis=0)])
    assert src.shape[0] == 5 * DB_BLOCK_SRC
    target = np.concatenate([target[:448], np.full(192, -1)])
    nbr = np.tile(np.arange(5, dtype=np.int32), (N_RECV_BLOCKS, 1))
    valid = np.ones(nbr.shape, bool)
    valid[2, 3:] = False
    return nbr, valid, src, recv, target


def torch_inputs(device, mixed=False, seed=0, make=edge_inputs):
    nbr, valid, src, recv, _ = make(seed, mixed)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (nbr, valid, src, recv))


def pair_terms(src, recv, target):
    """For each source row with a target receiver: rho2, the cone test
    value in ulps from its bound (`cone_dot_ulps`) and sin(phi), in the
    plain version's operation order (numpy float32)."""
    j = np.flatnonzero(target >= 0)
    r = target[j]
    dx = recv[0, r] - src[j, 0]
    dy = recv[1, r] - src[j, 1]
    rho2 = dx * dx + dy * dy
    inv = np.float32(1) / np.sqrt(np.maximum(rho2, np.float32(1e-30)))
    dxn, dyn = dx * inv, dy * inv
    cone_ulps = cone_dot_ulps(src[j, 0], src[j, 1], recv[:4, r])
    sinphi = dyn * src[j, 2] - dxn * src[j, 3]
    return j, rho2, cone_ulps, sinphi


def test_edge_inputs_sit_on_the_edges():
    """The construction puts pairs where the decisions are close: cone
    pairs within a few ulps of the bound on both sides, aligned pairs with
    |sin phi| of 0 to a few 1e-6 on both sides, coincident pairs, the screen
    edge exactly at the cutoff; and each such pair's own force (the plain
    version, float32, that pair alone) is far above the tolerance where it
    is tracked, so a decision taken differently shows in the sum."""
    nbr, valid, src, recv, target = edge_inputs()
    j, rho2, cone_ulps, sinphi = pair_terms(src, recv, target)
    kind = j % 8
    cone = np.isin(kind, (CONE_LEFT, CONE_RIGHT))
    assert (np.abs(cone_ulps[cone]) <= 3).sum() >= 30
    assert (cone_ulps[cone] < 0).any() and (cone_ulps[cone] > 0).any()
    ahead = np.isin(kind, (AHEAD_P2R_EDGE, AHEAD))
    assert np.all(np.abs(sinphi[ahead]) <= 4e-6)
    assert (sinphi[ahead] < 0).any() and (sinphi[ahead] > 0).any()
    assert np.abs(sinphi[ahead]).min() <= 1e-7
    assert np.all(rho2[kind == COINCIDENT] == 0)
    tiny = rho2[j == TINY_ROW][0]
    assert 0 < tiny < 1e-18
    dx = recv[0, 448] - src[448:, 0]
    rho2_edge = dx * dx
    assert np.all(rho2_edge[:32] == np.float32(CUTOFF ** 2))
    assert np.all(rho2_edge[32:] > np.float32(CUTOFF ** 2))

    # each tracked edge pair alone: forces far above the tolerance
    t = torch.as_tensor
    sel = j[np.isin(kind, (CONE_LEFT, CONE_RIGHT, AHEAD_P2R_EDGE, AHEAD))]
    r = target[sel]
    s = t(src[sel])[:, None, :]                       # [P, 1, 16]
    rv = [t(recv[k, r])[:, None, None] for k in range(5)]
    fx, fy = PF.tile_forces(s, *rv, uniform=UNIFORM)
    mag = torch.hypot(fx, fy).flatten()
    assert int((mag > 10 * ATOL).sum()) >= 40

    # the tiny pair alone: no force with its own sigma <= 0 columns, a
    # full one with the shared parameters (sigma > 0 there), so a P taken
    # as nonzero at sigma <= 0 shows in the sum
    s = t(src[[TINY_ROW]])[:, None, :]
    rv = [t(recv[k, [TINY_ROW]])[:, None, None] for k in range(5)]
    assert torch.hypot(*PF.tile_forces(s, *rv)).item() == 0.0
    assert torch.hypot(*PF.tile_forces(s, *rv, uniform=UNIFORM)).item() > 1.0

    # the plain version on the whole input: inactive receivers get 0, the
    # screens skip the far clusters' tiles
    tn, tv, ts, tr = torch_inputs("cpu")
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, uniform=UNIFORM)
    full = PF.pair_forces_neighbors_ref(tn, tv, ts, tr, **kw)
    assert torch.isfinite(full).all()
    assert torch.all(full[:, ::13] == 0)
    screened = PF.pair_forces_neighbors_ref(tn, tv, ts, tr, **kw,
                                            screen=True, cutoff=CUTOFF)
    strip = PF.pair_forces_neighbors_ref(tn, tv, ts, tr, **kw, screen=True,
                                         sub=32, cutoff=CUTOFF)
    assert not torch.equal(screened, full)
    assert not torch.equal(strip, screened)


# K1's forms: name -> (mixed pack, wrapper options)
FORMS = {
    "uniform": (False, {"uniform": UNIFORM}),
    "uniform_fov_off": (False, {"uniform": UNIFORM, "fov": False}),
    "uniform_p2r": (False, {"uniform": UNIFORM, "priority_p2r": True}),
    "uniform_screen": (False, {"uniform": UNIFORM, "screen": True}),
    "uniform_strip": (False, {"uniform": UNIFORM, "screen": True,
                              "sub": 32}),
    "columns": (False, {}),
    "columns_p2r": (False, {"priority_p2r": True}),
    "columns_screen": (False, {"screen": True}),
    "columns_strip": (False, {"screen": True, "sub": 32}),
    "mixed": (True, {"mixed": True}),
    "mixed_fov_off": (True, {"mixed": True, "fov": False}),
    "mixed_p2r": (True, {"mixed": True, "priority_p2r": True}),
    "mixed_screen": (True, {"mixed": True, "screen": True}),
    "mixed_strip": (True, {"mixed": True, "screen": True, "sub": 32}),
}


# K2's forms (no screen) and K3's (the tile screen and per-source columns
# always): name -> (mixed pack, wrapper options)
K2_FORMS = {
    "uniform": (False, {"uniform": UNIFORM}),
    "columns": (False, {}),
    "uniform_fov_off": (False, {"uniform": UNIFORM, "fov": False}),
    "uniform_p2r": (False, {"uniform": UNIFORM, "priority_p2r": True}),
    "mixed": (True, {"mixed": True}),
    "mixed_p2r": (True, {"mixed": True, "priority_p2r": True}),
}
K3_FORMS = {
    "columns": (False, {}),
    "columns_p2r": (False, {"priority_p2r": True}),
    "mixed": (True, {"mixed": True}),
}
# K3's cutoff by seed: the screen-edge tile admitted, and skipped
K3_CUTOFF = {0: CUTOFF, 1: CUTOFF_BELOW}


@pytest.fixture
def pallas():
    """The JAX package's Pallas kernels (interpret mode) on numpy inputs:
    run(kernel, arrays, mixed, opts, cutoff) with kernel "k1", "k2" or
    "k3" and `opts` a form's wrapper options."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from cyclistsocialforce_tpu.ops import pallas_forces

    def run(kernel, arrays, mixed, opts, cutoff=CUTOFF):
        jn, jv, js, jr = (jnp.asarray(a) for a in arrays)
        common = dict(block=BLOCK, interpret=True, mixed=mixed,
                      fov=opts.get("fov", True),
                      priority_p2r=opts.get("priority_p2r", False))
        if kernel == "k1":
            out = pallas_forces.pair_forces_neighbors(
                jn, jv, js, jr, block_src=BLOCK_SRC, cutoff=cutoff,
                screen=opts.get("screen", False), sub=opts.get("sub", 0),
                uniform=opts.get("uniform"), **common)
        elif kernel == "k2":
            out = pallas_forces.pair_forces_neighbors_unrolled(
                jn, jv, js, jr, block_src=BLOCK_SRC,
                uniform=opts.get("uniform"), **common)
        else:
            out = pallas_forces.pair_forces_neighbors_db(
                jn, jv, js, jr, cutoff=cutoff, **common)
        return np.asarray(out)

    return run


def assert_edges_decided_as(want, got, src, recv, target, mixed, uniform):
    """`got` (the port's plain version) against `want` (the Pallas kernel,
    interpret mode): within ATOL + RTOL |want| at every receiver but those
    of the pairs placed on the cone edge, on the priority edge or straight
    ahead, where they differ by at most that pair's own force, twice (the
    jump at phi = 0 reverses it). Returns (receivers that differ, edge
    receivers, max |diff|)."""
    err = np.abs(got - want)
    tol = ATOL + RTOL * np.abs(want)
    assert np.abs(want).max() > 1.0

    rows = np.flatnonzero((target >= 0)
                          & np.isin(np.arange(len(target)) % 8, EDGE_KINDS))
    edge = np.zeros(recv.shape[1], bool)
    edge[target[rows]] = True
    assert np.all(err[:, ~edge] <= tol[:, ~edge])

    # each edge pair's own force with every decision taken to "tracked"
    t = torch.as_tensor
    rv = [t(recv[k, target[rows]])[:, None, None] for k in range(4)]
    fx, fy = PF.tile_forces(t(src[rows])[:, None, :], *rv,
                            torch.ones_like(rv[0]), fov=False, mixed=mixed,
                            uniform=uniform)
    own = torch.hypot(fx, fy).flatten().numpy()
    r = target[rows]
    assert np.all(err[:, r] <= tol[:, r] + 2 * own)
    return int((err > tol).any(0).sum()), int(edge.sum()), float(err.max())


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_decides_edges_as_pallas_interpret(pallas, form, seed):
    """The port's plain float32 version (its wrapper on CPU tensors) in
    each form against the JAX package's Pallas kernel of the same form in
    interpret mode, on the edge inputs. Every force agrees within ATOL +
    RTOL |JAX| but at the receivers of the pairs placed on the cone edge,
    on the priority edge or straight ahead: there the two may take that
    one pair's decision differently, because XLA on the CPU contracts
    a*b + c*d into fused multiply-adds and rounds rsqrt its own way (not
    as 1 / sqrt), so a decision value a few ulps from its bound can land
    on the other side. There they differ by at most that pair's own
    force, twice (the jump at phi = 0 reverses it). Coincident pairs,
    sigma <= 0 (the tiny pair too), silent rows, inactive receivers and
    the screen's cutoff are decided alike."""
    mixed, opts = FORMS[form]
    nbr, valid, src, recv, target = edge_inputs(seed, mixed)
    want = pallas("k1", (nbr, valid, src, recv), mixed, opts)
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, cutoff=CUTOFF, **opts)
    PF.reset_launches()
    got = PF.pair_forces_neighbors(*torch_inputs("cpu", mixed, seed), **kw)
    assert PF.pair_forces_neighbors.launches == 0
    n_diff, n_edge, worst = assert_edges_decided_as(
        want, got.numpy(), src, recv, target, mixed, opts.get("uniform"))
    print(f"{form} seed {seed}: {n_diff} of {n_edge} edge receivers "
          f"differ, max |diff| {worst:.3e}")


@pytest.mark.parametrize("form", sorted(K2_FORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_decides_edges_as_pallas_interpret_k2(pallas, form, seed):
    """K2's wrapper on CPU tensors (the plain version, unscreened) in each
    of K2's forms against the JAX package's
    `pair_forces_neighbors_unrolled` in interpret mode on the edge
    inputs, by the rule of `test_plain_decides_edges_as_pallas_interpret`."""
    mixed, opts = K2_FORMS[form]
    nbr, valid, src, recv, target = edge_inputs(seed, mixed)
    want = pallas("k2", (nbr, valid, src, recv), mixed, opts)
    PF.reset_launches()
    got = PF.pair_forces_neighbors_unrolled(
        *torch_inputs("cpu", mixed, seed), block=BLOCK, block_src=BLOCK_SRC,
        **opts)
    assert PF.pair_forces_neighbors_unrolled.launches == 0
    assert_edges_decided_as(want, got.numpy(), src, recv, target, mixed,
                            opts.get("uniform"))


@pytest.mark.parametrize("form", sorted(K3_FORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_decides_edges_as_pallas_interpret_k3(pallas, form, seed):
    """K3's wrapper on CPU tensors (the plain version with the tile screen
    and per-source columns) in each of K3's forms against the JAX
    package's `pair_forces_neighbors_db` in interpret mode, on the edge
    inputs rebuilt at block_src 128, by the same rule. Seed 0 runs at the
    cutoff that admits the screen-edge tile, seed 1 at the float32 just
    below, which skips it; both decide the tile alike. In the mixed form
    the tile's legacy rows push the edge receivers by more than the
    tolerance, so the two cutoffs give different sums."""
    mixed, opts = K3_FORMS[form]
    cutoff = K3_CUTOFF[seed]
    nbr, valid, src, recv, target = edge_inputs_db(seed, mixed)
    want = pallas("k3", (nbr, valid, src, recv), mixed, opts, cutoff)
    tensors = torch_inputs("cpu", mixed, seed, edge_inputs_db)
    PF.reset_launches()
    got = PF.pair_forces_neighbors_db(*tensors, block=BLOCK, cutoff=cutoff,
                                      **opts)
    assert PF.pair_forces_neighbors_db.launches == 0
    assert torch.all(got[:, ::13] == 0)
    assert_edges_decided_as(want, got.numpy(), src, recv, target, mixed,
                            None)
    if mixed:
        other = PF.pair_forces_neighbors_db(
            *tensors, block=BLOCK, cutoff=K3_CUTOFF[1 - seed], **opts)
        moved = (got - other).abs()[:, 448:]
        assert moved.max() > 10 * ATOL
        assert torch.equal(got[:, :384], other[:, :384])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def check_cuda_edges(fn, tensors, kw, plain_kw):
    """Kernel `fn` on the card against its plain version: every force
    within ATOL + RTOL |plain| (a pair decided the other way would move a
    force by more), inactive receivers exactly 0, one launch counted, and
    the same call twice the same bits (the groups' partial sums are added
    in a fixed order)."""
    before = fn.launches
    got = fn(*tensors, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = PF.pair_forces_neighbors_ref(*tensors, **plain_kw)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert torch.all(got[:, ::13] == 0)
    assert want.abs().max() > 1.0
    assert torch.equal(fn(*tensors, **kw), got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_k1_decides_edges_as_plain(cuda_device, form, seed):
    """K1 in each form against its plain version on the card
    (`check_cuda_edges`)."""
    mixed, opts = FORMS[form]
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, cutoff=CUTOFF, **opts)
    check_cuda_edges(PF.pair_forces_neighbors,
                     torch_inputs(cuda_device, mixed, seed), kw, kw)


# K1's forms that take its cone loop: the FOV cone on, one family
CONE_FORMS = sorted(f for f, (mixed, opts) in FORMS.items()
                    if not mixed and opts.get("fov", True))


def edge_inputs_at(block, seed=0):
    """`edge_inputs` regrouped into receiver blocks of `block`: at 64 each
    block of 128 splits in two that keep its table (block 2's short
    prefix too); at 256 two neighbouring clusters share one block, whose
    table lists every source block."""
    nbr, valid, src, recv, target = edge_inputs(seed)
    if block == 64:
        nbr, valid = nbr.repeat(2, axis=0), valid.repeat(2, axis=0)
    elif block == 256:
        nbr, valid = nbr[::2], np.ones(nbr[::2].shape, bool)
    return nbr, valid, src, recv, target


@pytest.mark.cuda
@pytest.mark.parametrize("form", CONE_FORMS)
@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_k1_cone_forms_decide_edges_at_each_block(cuda_device, form,
                                                       block, seed):
    """K1's cone loop in each of its forms (uniform and per-row
    parameters, priority to the right, the tile and strip screens) at
    every receiver block against the plain version on the edge inputs
    (`check_cuda_edges`: every force within the bar, so every edge pair
    decided alike, and the same bits on a second call), and its
    `field_pairs` equal to `field_pairs_ref`."""
    _, opts = FORMS[form]
    arrays = edge_inputs_at(block, seed)[:4]
    tensors = tuple(torch.as_tensor(a, device=cuda_device) for a in arrays)
    kw = dict(block=block, block_src=BLOCK_SRC, cutoff=CUTOFF, **opts)
    check_cuda_edges(PF.pair_forces_neighbors, tensors, kw, kw)
    counter = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    PF.pair_forces_neighbors(*tensors, **kw, field_pairs=counter)
    assert int(counter) == PF.field_pairs_ref(*tensors, **kw) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(K2_FORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_k2_decides_edges_as_plain(cuda_device, form, seed):
    """K2 in each form against its plain version on the card
    (`check_cuda_edges`)."""
    mixed, opts = K2_FORMS[form]
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, **opts)
    check_cuda_edges(PF.pair_forces_neighbors_unrolled,
                     torch_inputs(cuda_device, mixed, seed), kw, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(K3_FORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_k3_decides_edges_as_plain(cuda_device, form, seed):
    """K3 in each form against its plain version on the card
    (`check_cuda_edges`), on the edge inputs at block_src 128: at the
    cutoff that admits the screen-edge tile (seed 0) and at the one that
    skips it (seed 1)."""
    mixed, opts = K3_FORMS[form]
    cutoff = K3_CUTOFF[seed]
    kw = dict(block=BLOCK, cutoff=cutoff, **opts)
    plain_kw = dict(kw, block_src=DB_BLOCK_SRC, screen=True)
    check_cuda_edges(PF.pair_forces_neighbors_db,
                     torch_inputs(cuda_device, mixed, seed, edge_inputs_db),
                     kw, plain_kw)
