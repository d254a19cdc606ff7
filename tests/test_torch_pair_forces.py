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
    torch.testing.assert_close(got, want, atol=1e-4, rtol=2e-4)
    assert want.abs().max() > 1.0
    cols = {**kw, "uniform": None}
    torch.testing.assert_close(
        PF.pair_forces_neighbors(tn, tv, ts, tr, **cols, mixed=True),
        PF.pair_forces_neighbors(tn, tv, ts, tr, **cols), rtol=0, atol=0)
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
