"""PyTorch port: the pair pack and the unscreened block-sparse pair sum of
the main path (`ops/pair_forces.py`, K1) held to the JAX package's Pallas
kernel (run in interpret mode) and its XLA oracle; the CUDA kernel held to
its plain version where a card is present. The other forms and kernels
are tested in test_torch_pair_variants.py.

The JAX package comes in through the `jx` fixture, so the card's tests
also run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_pair_forces.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import bicycle2d  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402
from cyclistsocialforce_tpu_torch.params import BicycleParams  # noqa: E402
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
BLOCK, BLOCK_SRC, KB = 128, 64, 16
# the JAX package's float32 bar for its Pallas kernels against its plain
# version (tests/test_neighbors.py): |kernel - plain| <= ATOL + RTOL |plain|
ATOL, RTOL = 1e-4, 2e-4


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from cyclistsocialforce_tpu import engine, make_state, params
    from cyclistsocialforce_tpu.models import bicycle2d as jax_bicycle2d
    from cyclistsocialforce_tpu.ops import pallas_forces

    return types.SimpleNamespace(jnp=jnp, JE=engine, JP=params,
                                 make_state=make_state,
                                 bicycle2d=jax_bicycle2d, JPF=pallas_forces)


def crowd(jx, n=1000, side=112.0, seed=0, per_agent=False, hfov=None):
    """Bench-style crowd plus both engines (JAX: `backend` xla)."""
    jnp, JE, JP = jx.jnp, jx.JE, jx.JP
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0:2] = rng.uniform(-side, side, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1, 6, n)
    st = jx.make_state(s0, dtype=jnp.float64, hist_len=8)
    active = np.ones(n, bool)
    active[[3, 17]] = False
    st = st.replace(active=jnp.asarray(active))
    kw = {} if hfov is None else {"hfov": hfov}
    p = JP.BicycleParams.create(**kw)
    if per_agent:
        p = JP.as_population(p, n)
        p = p.replace(f_0=p.f_0.at[5].set(0.0),
                      sigma_1=p.sigma_1 * (1 + 0.01 * rng.uniform(size=n)))
    cfg = JE.NeighborConfig(cutoff=50.0, block=BLOCK, block_src=BLOCK_SRC,
                            kb=KB, backend="xla")
    jeng = JE.Engine.create(p, jx.bicycle2d, rep_force="twod",
                            neighbors=cfg)
    teng = TE.Engine.create(
        convert.params_from_jax(p, device=DEV), bicycle2d, rep_force="twod",
        neighbors=TE.NeighborConfig(cutoff=50.0, block=BLOCK,
                                    block_src=BLOCK_SRC, kb=KB,
                                    screen=False))
    return st, jeng, teng


@pytest.mark.parametrize("per_agent", [False, True])
def test_pack_pair_fields_matches_jax(jx, per_agent):
    """Same pack at float64, pad rows included (1000 agents pad to 1024).
    Columns that come out of cos/sin may differ by an ulp between the two
    libraries' libm; every other column is equal."""
    st, jeng, teng = crowd(jx, per_agent=per_agent)
    npad = 1024
    jsrc, jrecv = jeng.pack_pair_fields(st, npad)
    tsrc, trecv = teng.pack_pair_fields(convert.state_from_jax(st, DEV),
                                        npad)
    trig_src, trig_recv = (2, 3, 11), (2, 3)
    for got, want, trig in ((tsrc.numpy(), np.asarray(jsrc), trig_src),
                            (trecv.numpy().T, np.asarray(jrecv).T,
                             trig_recv)):
        assert got.shape == want.shape
        for c in range(want.shape[1]):
            if c in trig:
                np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                           atol=4.5e-16, err_msg=str(c))
            else:
                np.testing.assert_array_equal(got[:, c], want[:, c],
                                              err_msg=str(c))


def sorted_inputs(tst, teng, dtype):
    """Torch tensors of one cell-sorted table and packs."""
    cache = TE.build_neighbor_cache(teng.neighbors, tst)
    src, recv = teng.pack_pair_fields(tst, -(-tst.n // BLOCK) * BLOCK)
    src, recv = TE.sorted_packs(src, cache[0])
    return cache[1], cache[2], src.to(dtype), recv.to(dtype)


def as_jax(jx, tensors):
    return tuple(jx.jnp.asarray(a.cpu().numpy()) for a in tensors)


def test_plain_f32_matches_pallas_kernel_interpret(jx):
    """The plain version in float32 against the JAX package's K1 (the
    Pallas `_pair_kernel`, interpret mode) on the same packs, at the JAX
    package's own float32 bar (tests/test_neighbors.py)."""
    st, jeng, teng = crowd(jx)
    assert teng.uniform_pair == jeng.uniform_pair
    tn, tv, ts, tr = sorted_inputs(convert.state_from_jax(st, DEV), teng,
                                   torch.float32)
    jn, jv, js, jr = as_jax(jx, (tn, tv, ts, tr))
    want = np.asarray(jx.JPF.pair_forces_neighbors(
        jn, jv, js, jr, block=BLOCK, interpret=True,
        uniform=jeng.uniform_pair, fov=True, screen=False,
        block_src=BLOCK_SRC))
    got = PF.pair_forces_neighbors_ref(tn, tv, ts, tr, block=BLOCK,
                                       block_src=BLOCK_SRC,
                                       uniform=teng.uniform_pair).numpy()
    err = np.abs(got - want)
    print(f"plain f32 vs Pallas interpret: max |diff| {err.max():.3e}, "
          f"max |force| {np.abs(want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=2e-4)
    assert np.abs(want).max() > 1.0            # real forces compared


@pytest.mark.parametrize("per_agent,hfov", [(False, None), (True, None),
                                            (False, 2 * np.pi)])
def test_plain_f64_matches_xla_oracle(jx, per_agent, hfov):
    """float64: the plain version (shared-parameter form, per-agent
    columns, FOV on or off) against the JAX XLA oracle."""
    st, jeng, teng = crowd(jx, per_agent=per_agent, hfov=hfov)
    fov = not teng.full_fov
    assert fov == (not jeng.full_fov)
    assert (teng.uniform_pair is None) == per_agent
    tn, tv, ts, tr = sorted_inputs(convert.state_from_jax(st, DEV), teng,
                                   torch.float64)
    jn, jv, js, jr = as_jax(jx, (tn, tv, ts, tr))
    want = np.asarray(jx.JPF.pair_forces_neighbors_xla(
        jn, jv, js, jr, block=BLOCK, fov=fov, block_src=BLOCK_SRC))
    got = PF.pair_forces_neighbors(tn, tv, ts, tr, block=BLOCK,
                                   block_src=BLOCK_SRC, fov=fov,
                                   uniform=teng.uniform_pair).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    if not per_agent:
        cols = PF.pair_forces_neighbors_ref(tn, tv, ts, tr, block=BLOCK,
                                            block_src=BLOCK_SRC, fov=fov)
        np.testing.assert_allclose(cols.numpy(), got, rtol=0, atol=1e-12)


def port_crowd(n, device, dtype=torch.float32):
    """Bench-style crowd (0.02 /m^2) and engine from the port alone."""
    st = build_population(n, 0.02, 8, BLOCK, dtype, device)
    teng = TE.Engine.create(
        BicycleParams.create(), bicycle2d, rep_force="twod",
        neighbors=TE.NeighborConfig(cutoff=50.0, block=BLOCK,
                                    block_src=BLOCK_SRC, kb=19,
                                    screen=False))
    return st, teng


def test_wrapper_on_cpu_runs_plain_and_rejects_unported_variants():
    st, teng = port_crowd(256, DEV)
    tn, tv, ts, tr = sorted_inputs(st, teng, torch.float32)
    PF.pair_forces_neighbors.launches = 0
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, uniform=teng.uniform_pair)
    np.testing.assert_array_equal(
        PF.pair_forces_neighbors(tn, tv, ts, tr, **kw),
        PF.pair_forces_neighbors_ref(tn, tv, ts, tr, **kw))
    assert PF.pair_forces_neighbors.launches == 0
    # every form runs; the mixed-family form on a twod pack (family 0 on
    # every row) is the per-source-column form, and takes no constants
    for form in ({"priority_p2r": True}, {"screen": True},
                 {"screen": True, "sub": 8}, {"fov": False},
                 {"uniform": None}, {"uniform": None, "mixed": True}):
        out = PF.pair_forces_neighbors(tn, tv, ts, tr, **{**kw, **form})
        assert out.shape == tr[:2].shape and torch.isfinite(out).all()
    cols = {**kw, "uniform": None}
    np.testing.assert_array_equal(
        PF.pair_forces_neighbors(tn, tv, ts, tr, **cols, mixed=True),
        PF.pair_forces_neighbors(tn, tv, ts, tr, **cols))
    with pytest.raises(ValueError, match="mixed"):
        PF.pair_forces_neighbors(tn, tv, ts, tr, **kw, mixed=True)
    assert PF.pair_forces_neighbors.launches == 0
    with pytest.raises(ValueError):
        PF.pair_forces_neighbors(tn, tv, ts[:100], tr, **kw)


def line_inputs(n=1024, facing=(0.0, 1.0), block=BLOCK,
                block_src=BLOCK_SRC, device=DEV):
    """(nbr, valid, src, recv) packs of `n` riders on the x axis, 0.7 m
    apart, every one heading `facing` (cos, sin): with the default
    heading, straight across the line, no receiver sees a source inside its
    FOV cone (the cone test's dot product is 0). Each receiver block's
    table holds the source blocks within 120 m, a valid prefix."""
    x = 0.7 * torch.arange(n, dtype=torch.float32)
    src = torch.zeros((n, PF.SRC_COLS))
    src[:, 0] = x
    src[:, 2], src[:, 3] = facing
    src[:, 4] = 7.0
    src[:, 5:11] = torch.tensor((0.995, 0.7, 0.5, 5.0, 0.3, 4.9))
    src[:, 11] = 0.5
    src[:, 12] = src[:, 15] = 1.0
    recv = torch.zeros((PF.RECV_ROWS, n))
    recv[0] = x
    recv[2], recv[3] = facing
    recv[4] = 1.0
    n_blocks, n_src_blocks = n // block, n // block_src
    centre = 0.7 * (torch.arange(n_blocks) + 0.5) * block
    src_centre = 0.7 * (torch.arange(n_src_blocks) + 0.5) * block_src
    near = (centre[:, None] - src_centre[None, :]).abs() < 120.0
    kb = int(near.sum(1).max())
    order = torch.argsort((~near).to(torch.int8), dim=1, stable=True)
    nbr = order[:, :kb].to(torch.int32).contiguous()
    valid = torch.arange(kb)[None, :] < near.sum(1, keepdim=True)
    return tuple(a.to(device) for a in (nbr, valid, src, recv))


def with_shared_columns(src, uniform):
    """`src` with every row's field columns (e_0, e_1, sigma_0..3,
    cos(hfov / 2)) holding the shared constants `uniform`, and those
    constants as the float32 values the columns hold."""
    src = src.clone()
    src[:, PF._E0:PF._CHF + 1] = torch.tensor(uniform, dtype=src.dtype)
    return src, tuple(float(v) for v in src[0, PF._E0:PF._CHF + 1])


def test_field_pairs_ref_counts_by_the_unit_rule():
    """The plain count of K1's evaluated pairs: every walked pair without
    the cone or in the mixed form; in the cone forms whole units of
    FIELD_UNIT rows, none for a crowd that faces away from every source
    or whose receivers are all inactive, every walked row of a receiver
    whose heading is not finite, and the units of a source whose heading
    column is not finite."""
    st, teng = port_crowd(4096, DEV)
    tn, tv, ts, tr = sorted_inputs(st, teng, torch.float32)
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, uniform=teng.uniform_pair)
    walked = int(tv.sum()) * BLOCK * BLOCK_SRC
    cone = PF.field_pairs_ref(tn, tv, ts, tr, **kw)
    assert 0.3 * walked < cone < 0.6 * walked
    assert cone % PF.FIELD_UNIT == 0
    assert PF.field_pairs_ref(tn, tv, ts, tr, **kw, fov=False) == walked
    cols = {**kw, "uniform": None}
    assert PF.field_pairs_ref(tn, tv, ts, tr, **cols, mixed=True) == walked
    assert PF.field_pairs_ref(tn, tv, ts, tr, **cols) == cone
    assert PF.field_pairs_ref(tn, tv, ts, tr, **kw, priority_p2r=True) \
        < cone
    screened = PF.field_pairs_ref(tn, tv, ts, tr, **kw, screen=True,
                                  sub=8, cutoff=20.0)
    assert 0 < screened < cone
    off = tr.clone()
    off[4] = 0.0
    assert PF.field_pairs_ref(tn, tv, ts, off, **kw) == 0
    assert PF.field_pairs_ref(*line_inputs(), **kw) == 0
    assert PF.field_pairs_ref(*line_inputs(), **kw, fov=False) > 0
    # receiver 5's heading, then source row 9's heading column
    r = 5
    rows = int(tv[r // BLOCK].sum()) * BLOCK_SRC
    bad = tr.clone()
    bad[3, r] = float("nan")
    gained = PF.field_pairs_ref(tn, tv, ts, bad, **kw) - cone
    assert 0 < gained <= rows and gained % PF.FIELD_UNIT == 0
    bad_src = ts.clone()
    bad_src[9, 2] = float("inf")
    assert PF.field_pairs_ref(tn, tv, bad_src, tr, **kw) > cone


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    st, teng = port_crowd(20_000, cuda_device)
    tn, tv, ts, tr = sorted_inputs(st, teng, torch.float32)
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, uniform=teng.uniform_pair)
    before = PF.pair_forces_neighbors.launches
    got = PF.pair_forces_neighbors(tn, tv, ts, tr, **kw)
    torch.cuda.synchronize()
    assert PF.pair_forces_neighbors.launches == before + 1
    want = PF.pair_forces_neighbors_ref(tn, tv, ts, tr, **kw)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert want.abs().max() > 1.0
    # the mixed form on a twod pack is the per-source-column form: bit for
    # bit where both walk every pair (no FOV cone), within the kernels'
    # bar where the column form evaluates only the units its cone needs
    # and sums in its own order
    cols = {**kw, "uniform": None}
    for fov in (False, True):
        torch.testing.assert_close(
            PF.pair_forces_neighbors(tn, tv, ts, tr, **cols, fov=fov,
                                     mixed=True),
            PF.pair_forces_neighbors(tn, tv, ts, tr, **cols, fov=fov),
            rtol=RTOL if fov else 0, atol=ATOL if fov else 0)
    # the cone loop's uniform form against its column form, every row's
    # columns holding the shared constants: the same floats through the
    # same loop, bit for bit (priority to the right off and on)
    same, u = with_shared_columns(ts, teng.uniform_pair)
    for p2r in (False, True):
        torch.testing.assert_close(
            PF.pair_forces_neighbors(tn, tv, ts, tr, **{**kw, "uniform": u},
                                     priority_p2r=p2r),
            PF.pair_forces_neighbors(tn, tv, same, tr, **cols,
                                     priority_p2r=p2r),
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="mixed"):
        PF.pair_forces_neighbors(tn, tv, ts, tr, **kw, mixed=True)
    with pytest.raises(ValueError):
        PF.pair_forces_neighbors(tn, tv, ts.cpu(), tr, **kw)
    with pytest.raises(TypeError):
        PF.pair_forces_neighbors(tn, tv, ts.double(), tr.double(), **kw)


@pytest.mark.cuda
def test_cuda_simulate_launches_kernel_every_step(cuda_device):
    st, teng = port_crowd(4096, cuda_device)
    PF.pair_forces_neighbors.launches = 0
    # the eager loop: every step goes through the wrapper (the graphed
    # loop's counts are held in test_torch_graph.py)
    final, _ = teng.simulate(st, 25, record=False, graph=False)
    torch.cuda.synchronize()
    assert PF.pair_forces_neighbors.launches == 25
    assert torch.isfinite(final.s).all()
    assert not teng.neighbor_cache(final)[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("form", [
    {}, {"priority_p2r": True}, {"uniform": None}, {"fov": False},
    {"screen": True, "sub": 32, "cutoff": 20.0},
    {"uniform": None, "mixed": True}])
def test_cuda_field_pairs_equal_the_plain_count(cuda_device, form):
    """K1's `field_pairs` equals `field_pairs_ref` on a seeded crowd in
    each form (the cone forms' units, every walked pair in the others),
    adds up over calls, and leaves the forces as they are."""
    st, teng = port_crowd(20_000, cuda_device)
    tensors = sorted_inputs(st, teng, torch.float32)
    kw = {**dict(block=BLOCK, block_src=BLOCK_SRC,
                 uniform=teng.uniform_pair), **form}
    counter = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    got = PF.pair_forces_neighbors(*tensors, **kw, field_pairs=counter)
    want = PF.field_pairs_ref(*tensors, **kw)
    walked = int(tensors[1].sum()) * BLOCK * BLOCK_SRC
    assert int(counter) == want
    assert (want < 0.6 * walked) == (kw.get("fov", True)
                                     and not kw.get("mixed", False))
    assert torch.equal(PF.pair_forces_neighbors(*tensors, **kw), got)
    PF.pair_forces_neighbors(*tensors, **kw, field_pairs=counter)
    assert int(counter) == 2 * want
    with pytest.raises(ValueError, match="field_pairs"):
        PF.pair_forces_neighbors(*tensors, **kw,
                                 field_pairs=counter.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("uniform,p2r", [(True, False), (True, True),
                                         (False, False), (False, True)])
def test_cuda_non_finite_riders_poison_the_receivers_plain_does(
        cuda_device, uniform, p2r):
    """A source with a NaN position, one with an infinite heading column,
    one (per-row form) with an infinite field column, and a receiver with
    a NaN heading make the same active receivers non-finite in K1 as in
    the plain version, however few of their pairs are tracked."""
    st, teng = port_crowd(20_000, cuda_device)
    tn, tv, ts, tr = sorted_inputs(st, teng, torch.float32)
    ts, tr = ts.clone(), tr.clone()
    ts[1000, 0] = float("nan")
    ts[7000, 2] = float("inf")
    ts[13000, 7] = float("inf")                 # sigma_0
    tr[2, 16000] = float("nan")
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, priority_p2r=p2r,
              uniform=teng.uniform_pair if uniform else None)
    got = PF.pair_forces_neighbors(tn, tv, ts, tr, **kw)
    want = PF.pair_forces_neighbors_ref(tn, tv, ts, tr, **kw)
    active = tr[4] > 0
    bad_got = ~torch.isfinite(got).all(0) & active
    bad_want = ~torch.isfinite(want).all(0) & active
    assert torch.equal(bad_got, bad_want)
    assert int(bad_want.sum()) > 100
    ok = active & ~bad_want
    torch.testing.assert_close(got[:, ok], want[:, ok], atol=ATOL,
                               rtol=RTOL)
    # a receiver inactive: 0, whatever its pairs hold (the plain version's
    # mask is a product there, which a non-finite input can make NaN)
    assert torch.all(got[:, ~active] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 128, 256])
def test_cuda_crowd_facing_away_gets_exactly_nothing(cuda_device, block):
    """Riders on a line, every one heading across it: no source lies in
    any receiver's cone, so K1's forces are exactly 0 and it evaluates no
    pair; heading along the line they see each other, as in the plain
    version."""
    tensors = line_inputs(block=block, device=cuda_device)
    kw = dict(block=block, block_src=64, uniform=(0.995, 0.7, 0.5, 5.0,
                                                  0.3, 4.9, 0.5))
    counter = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    got = PF.pair_forces_neighbors(*tensors, **kw, field_pairs=counter)
    assert torch.equal(got, torch.zeros_like(got))
    assert int(counter) == 0
    along = line_inputs(block=block, facing=(1.0, 0.0), device=cuda_device)
    got = PF.pair_forces_neighbors(*along, **kw, field_pairs=counter)
    torch.testing.assert_close(
        got, PF.pair_forces_neighbors_ref(*along, **kw), atol=ATOL,
        rtol=RTOL)
    assert got.abs().max() > 1.0
    assert int(counter) == PF.field_pairs_ref(*along, **kw) > 0
