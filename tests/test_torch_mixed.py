"""PyTorch port: bicycle2d's default legacy field through the culled pair
stage, i.e. the mixed-family form of the three pair kernels
(`ops/pair_forces.py`, `mixed=True`), the legacy pack and
`Engine.create`'s legacy family, held to the JAX package: its XLA oracle
at float64, its Pallas kernels in interpret mode at float32, its legacy
`pack_pair_fields` and `repulsive_sum_neighbors`, and the port's own dense
stage. The CUDA kernels are held to their plain versions where a card is
present.

The JAX package comes in through the `jx` fixture, so the card's tests
also run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_mixed.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import bicycle2d  # noqa: E402
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, as_population)
from cyclistsocialforce_tpu_torch.scenarios import \
    build_population  # noqa: E402
from cyclistsocialforce_tpu_torch.state import make_state  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
# the JAX package's float32 bar for its Pallas kernels against its float64
# oracle (tests/test_neighbors.py): |port - JAX| <= ATOL + RTOL |JAX|
ATOL, RTOL = 1e-4, 2e-4
N, SIDE, BLOCK, KB = 256, 120.0, 64, 4
# screened forms: a cutoff at which the screens skip tiles and strips of
# the table (built at a cutoff covering the domain, so every block is in)
SCREEN_CUTOFF = 20.0

# form -> (kernel, options); block = block_src = 64 throughout
FORMS = {
    "k1": ("k1", {}),
    "k1_screen": ("k1", {"screen": True}),
    "k1_screen_sub32": ("k1", {"screen": True, "sub": 32}),
    "k1_fov_off": ("k1", {"fov": False}),
    "k1_p2r": ("k1", {"priority_p2r": True}),
    "k2": ("k2", {}),
    "k3": ("k3", {}),
}
PORT_KERNELS = {"k1": PF.pair_forces_neighbors,
                "k2": PF.pair_forces_neighbors_unrolled,
                "k3": PF.pair_forces_neighbors_db}


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from cyclistsocialforce_tpu import engine, make_state, params
    from cyclistsocialforce_tpu.models import bicycle2d as jax_bicycle2d
    from cyclistsocialforce_tpu.ops import pallas_forces

    return types.SimpleNamespace(jax=jax, jnp=jnp, JE=engine, JP=params,
                                 make_state=make_state,
                                 bicycle2d=jax_bicycle2d, JPF=pallas_forces)


def riders(n=N, side=SIDE, seed=3):
    """Initial states [n, 5] in a side x side box (as the JAX package's
    tests/test_neighbors.py draws them), one rider braking (v < 0)."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 5))
    s0[:, 0] = rng.uniform(0, side, n)
    s0[:, 1] = rng.uniform(0, side, n)
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.uniform(1, 6, n)
    s0[9, 3] = -0.3
    return s0


def jittered(p, n, seed=5):
    """Per-rider f_0 and sigma_0 (+-5%, seeded numpy) on the port's
    params."""
    rng = np.random.default_rng(seed)
    p = as_population(p, n, DEV)
    return p.replace(
        f_0=p.f_0 * torch.as_tensor(1 + 0.05 * rng.uniform(-1, 1, n)),
        sigma_0=p.sigma_0 * torch.as_tensor(1 + 0.05 * rng.uniform(-1, 1, n)))


def two_family_inputs(dtype, hfov=None, device=DEV, n=N, side=SIDE,
                      block=BLOCK, kb=KB, cutoff=1e4):
    """(nbr, valid, src, recv) of a two-family pack: the legacy pack of a
    crowd, cell-sorted, with every other rider (odd uid) a twod row of
    per-rider columns (family 0). Inactive riders included."""
    kw = {} if hfov is None else {"hfov": hfov}
    st = make_state(riders(n, side), dtype=dtype, hist_len=8, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    active[[4, 17]] = False
    st = st.replace(active=active)
    cfg = TE.NeighborConfig(cutoff=cutoff, block=block, kb=kb)
    leg = TE.Engine.create(BicycleParams.create(**kw), bicycle2d,
                           neighbors=cfg)
    twod = TE.Engine.create(jittered(BicycleParams.create(**kw), n),
                            bicycle2d, rep_force="twod", neighbors=cfg)
    cache = leg.neighbor_cache(st)
    assert not cache[3].any()
    st = TE.permute_state(st, cache[0])
    src_leg, recv = leg.pack_pair_fields(st)
    src_twod, _ = twod.pack_pair_fields(st)
    odd = (st.uid % 2 == 1)[:, None]
    src = torch.where(odd, src_twod, src_leg)
    assert 0.4 < float(src[:, 13].mean()) < 0.6       # half of each
    return cache[1], cache[2], src, recv


def port_kw(form, cutoff=SCREEN_CUTOFF):
    kernel, opts = FORMS[form]
    kw = dict(block=BLOCK, mixed=True, fov=opts.get("fov", True),
              priority_p2r=opts.get("priority_p2r", False))
    if kernel != "k3":
        kw["block_src"] = BLOCK
    if kernel == "k1":
        kw.update(screen=opts.get("screen", False), sub=opts.get("sub", 0))
    if kernel != "k2":
        kw["cutoff"] = cutoff
    return kernel, kw


def plain_kw(kernel, kw):
    kw = dict(kw)
    if kernel == "k3":
        kw.update(block_src=BLOCK, screen=True)
    return kw


# ---- the legacy pack ------------------------------------------------------


@pytest.mark.parametrize("per_agent", [False, True])
def test_legacy_pack_matches_jax(jx, per_agent):
    """The legacy `pack_pair_fields`, padded (250 riders to 256), equal to
    the JAX package's; per-rider p_0, p_decay and v_max_riding carried
    over by `convert.params_from_jax`. Columns from cos, sin and pow may
    differ by an ulp between the two libraries; the others are equal."""
    n, npad = 250, 256
    s0 = riders(n)
    st = jx.make_state(s0, dtype=jx.jnp.float64, hist_len=8)
    active = np.ones(n, bool)
    active[[0, 7]] = False          # row 0 inactive: the pad copies it
    st = st.replace(active=jx.jnp.asarray(active))
    p = jx.JP.BicycleParams.create()
    if per_agent:
        rng = np.random.default_rng(1)
        p = jx.JP.as_population(p, n)
        p = p.replace(p_0=p.p_0 * (1 + 0.1 * rng.uniform(-1, 1, n)),
                      p_decay=p.p_decay * (1 + 0.1 * rng.uniform(-1, 1, n)),
                      v_max_riding=p.v_max_riding * np.array([1.0, 0.8]))
        p = p.replace(p_0=p.p_0.at[3].set(0.0))
    jeng = jx.JE.Engine.create(p, jx.bicycle2d,
                               neighbors=jx.JE.NeighborConfig(block=BLOCK))
    tp = convert.params_from_jax(p, DEV)
    if per_agent:
        for f in ("p_0", "p_decay", "v_max_riding"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(p, f)))
    teng = TE.Engine.create(tp, bicycle2d,
                            neighbors=TE.NeighborConfig(block=BLOCK))
    assert jeng.pair_family == teng.pair_family == "legacy"
    assert teng.uniform_pair is None
    jsrc, jrecv = jeng.pack_pair_fields(st, npad)
    tsrc, trecv = teng.pack_pair_fields(convert.state_from_jax(st, DEV),
                                        npad)
    assert tsrc[:n, 13].eq(1).all() and not tsrc[n:, 13].any()
    ulp = (2, 3, 5, 6, 11)
    for got, want, inexact in ((tsrc.numpy(), np.asarray(jsrc), ulp),
                               (trecv.numpy().T, np.asarray(jrecv).T,
                                (2, 3))):
        assert got.shape == want.shape
        for c in range(want.shape[1]):
            if c in inexact:
                np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                           atol=4.5e-16, err_msg=str(c))
            else:
                np.testing.assert_array_equal(got[:, c], want[:, c],
                                              err_msg=str(c))


# ---- the kernels' mixed form: plain version vs JAX --------------------------


@pytest.mark.parametrize("fov,p2r", [(True, False), (False, False),
                                     (True, True)])
def test_plain_f64_two_family_matches_xla_oracle(jx, fov, p2r):
    """float64: the plain version in the mixed form on a two-family pack
    against the JAX XLA oracle (`pair_forces_neighbors_xla(mixed=True)`),
    through each wrapper (K3 with a cutoff covering the domain)."""
    tensors = two_family_inputs(torch.float64,
                                hfov=None if fov else 2 * np.pi)
    jn, jv, js, jr = (jx.jnp.asarray(a.numpy()) for a in tensors)
    want = np.asarray(jx.JPF.pair_forces_neighbors_xla(
        jn, jv, js, jr, block=BLOCK, priority_p2r=p2r, mixed=True, fov=fov,
        block_src=BLOCK))
    assert np.abs(want).max() > 1.0
    for kernel, fn in PORT_KERNELS.items():
        kw = dict(block=BLOCK, mixed=True, fov=fov, priority_p2r=p2r)
        if kernel == "k3":
            kw["cutoff"] = 1e4
        else:
            kw["block_src"] = BLOCK
        got = fn(*tensors, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9,
                                   err_msg=kernel)


def jax_form(jx, kernel, tensors, kw):
    """The JAX package's Pallas kernel of the form, interpret mode."""
    jn, jv, js, jr = (jx.jnp.asarray(a.numpy()) for a in tensors)
    common = dict(block=BLOCK, interpret=True, fov=kw["fov"], mixed=True,
                  priority_p2r=kw["priority_p2r"])
    if kernel == "k1":
        return jx.JPF.pair_forces_neighbors(
            jn, jv, js, jr, cutoff=kw["cutoff"], screen=kw["screen"],
            sub=kw["sub"], block_src=BLOCK, **common)
    if kernel == "k2":
        return jx.JPF.pair_forces_neighbors_unrolled(
            jn, jv, js, jr, block_src=BLOCK, **common)
    return jx.JPF.pair_forces_neighbors_db(jn, jv, js, jr,
                                           cutoff=kw["cutoff"], **common)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_f32_two_family_matches_pallas_interpret(jx, form):
    """float32: each wrapper's plain version in the mixed form against the
    JAX package's Pallas kernel of the same form in interpret mode, on the
    same two-family packs; the screened forms skip what the table
    admitted."""
    kernel, kw = port_kw(form)
    fov = kw["fov"]
    tensors = two_family_inputs(torch.float32,
                                hfov=None if fov else 2 * np.pi)
    want = np.asarray(jax_form(jx, kernel, tensors, kw))
    PF.reset_launches()
    got = PORT_KERNELS[kernel](*tensors, **kw).numpy()
    assert all(fn.launches == 0 for fn in PF.KERNELS)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(want).max() > 1.0
    if kw.get("screen") or kernel == "k3":
        loose = PF.pair_forces_neighbors_ref(
            *tensors, **{**plain_kw(kernel, kw), "screen": False})
        assert (loose.numpy() != got).any()


def test_mixed_takes_no_uniform_constants():
    tensors = two_family_inputs(torch.float32)
    u = (0.995, 0.7, 0.5, 5.0, 0.3, 4.9, 0.5)
    for fn in (PF.pair_forces_neighbors, PF.pair_forces_neighbors_unrolled):
        with pytest.raises(ValueError, match="mixed"):
            fn(*tensors, block=BLOCK, mixed=True, uniform=u)
    with pytest.raises(ValueError, match="mixed"):
        PF.pair_forces_neighbors_ref(*tensors, block=BLOCK, mixed=True,
                                     uniform=u)


# ---- the culled legacy stage ------------------------------------------------


@pytest.mark.parametrize("backend", ["pallas", "pallas_unrolled",
                                     "pallas_db"])
def test_culled_legacy_matches_dense_and_jax(jx, backend):
    """bicycle2d's default field culled at a cutoff covering the domain
    equals the port's dense stage, and JAX's culled legacy stage on its
    XLA backend (tests/test_neighbors.py::
    test_legacy_family_culled_matches_dense); then 10 steps of `simulate`
    (two rebuild chunks, sorted-resident) against both."""
    s0 = riders()
    jst = jx.make_state(s0, dtype=jx.jnp.float64)
    jp = jx.JP.as_population(jx.JP.BicycleParams.create(), N)
    p = convert.params_from_jax(jp, DEV)
    st = convert.state_from_jax(jst, DEV)
    cfg = dict(cutoff=1e4, block=BLOCK, kb=KB)
    dense = TE.Engine.create(p, bicycle2d)
    culled = TE.Engine.create(p, bicycle2d, neighbors=TE.NeighborConfig(
        backend=backend, rebuild_every=5, **cfg))
    assert culled.pair_family == "legacy" and culled.uniform_pair is None
    jeng = jx.JE.Engine.create(jp, jx.bicycle2d,
                               neighbors=jx.JE.NeighborConfig(
                                   backend="xla", rebuild_every=5, **cfg))
    got = torch.stack(culled.repulsive_sum_neighbors(st)).numpy()
    np.testing.assert_allclose(
        got, torch.stack(dense.repulsive_sum(st)).numpy(), rtol=0,
        atol=1e-9)
    np.testing.assert_allclose(
        got, np.stack([np.asarray(f) for f in
                       jeng.repulsive_sum_neighbors(jst)]), rtol=0,
        atol=1e-9)
    assert np.abs(got).max() > 1.0

    fin_c, _ = culled.simulate(st, 10, record=False)
    fin_d, _ = dense.simulate(st, 10, record=False)
    want, _ = jx.jax.jit(lambda e, s: e.simulate(s, 10, record=False))(
        jeng, jst)
    np.testing.assert_allclose(fin_c.s.numpy(), fin_d.s.numpy(), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(fin_c.s.numpy(), np.asarray(want.s), rtol=0,
                               atol=1e-9)


def test_with_params_keeps_the_legacy_family():
    eng = TE.Engine.create(BicycleParams.create(), bicycle2d,
                           neighbors=TE.NeighborConfig())
    eng2 = eng.with_params(BicycleParams.create(hfov=2 * np.pi))
    assert eng2.pair_family == "legacy" and eng2.uniform_pair is None
    assert eng2.full_fov and not eng.full_fov


# ---- the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("two_family", [False, True])
def test_cuda_mixed_form_matches_plain(cuda_device, form, two_family):
    """Each mixed form's CUDA kernel against its plain version, 20k riders
    at 0.02 /m^2 with the legacy field's cutoff (100 m), block 128,
    block_src 64 (K3: 128), kb 40 (no overflow); the legacy crowd or a
    two-family pack. Its launch counter steps by one per call."""
    kernel, opts = FORMS[form]
    block_src = 128 if kernel == "k3" else 64
    st = build_population(20_000, 0.02, 8, 128, torch.float32, cuda_device)
    kw = {} if opts.get("fov", True) else {"hfov": 2 * np.pi}
    cfg = TE.NeighborConfig(cutoff=100.0, block=128, block_src=block_src,
                            kb=40)
    eng = TE.Engine.create(BicycleParams.create(**kw), bicycle2d,
                           neighbors=cfg)
    cache = eng.neighbor_cache(st)
    assert not cache[3].any()
    sst = TE.permute_state(st, cache[0])
    src, recv = eng.pack_pair_fields(sst)
    if two_family:
        p = as_population(BicycleParams.create(**kw), st.n, cuda_device)
        p = p.replace(f_0=p.f_0 * (1 + 0.05 * torch.rand(st.n,
                                                          device=cuda_device,
                                                          dtype=p.f_0.dtype)))
        twod = TE.Engine.create(p, bicycle2d, rep_force="twod",
                                neighbors=cfg)
        odd = (sst.uid % 2 == 1)[:, None]
        src = torch.where(odd, twod.pack_pair_fields(sst)[0], src)
    tensors = (cache[1], cache[2], src, recv)
    kw = dict(block=128, mixed=True, fov=opts.get("fov", True),
              priority_p2r=opts.get("priority_p2r", False))
    if kernel != "k3":
        kw["block_src"] = block_src
    if kernel == "k1":
        kw.update(screen=opts.get("screen", False), sub=opts.get("sub", 0))
    if kernel != "k2":
        kw["cutoff"] = 100.0
    fn = PORT_KERNELS[kernel]
    before = [k.launches for k in PF.KERNELS]
    got = fn(*tensors, **kw)
    torch.cuda.synchronize()
    after = [k.launches for k in PF.KERNELS]
    assert [a - b for a, b in zip(after, before)] == [
        int(k is fn) for k in PF.KERNELS]
    pkw = dict(kw)
    if kernel == "k3":
        pkw.update(block_src=128, screen=True)
    want = PF.pair_forces_neighbors_ref(*tensors, **pkw)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert want.abs().max() > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "pallas_unrolled",
                                     "pallas_db"])
def test_cuda_legacy_simulate_launches_backend_kernel(cuda_device, backend):
    """bicycle2d's default engine with a NeighborConfig of each backend:
    one launch of that kernel per step, a finite state, no overflow."""
    st = build_population(4096, 0.02, 8, 128, torch.float32, cuda_device)
    block_src = 128 if backend == "pallas_db" else 64
    eng = TE.Engine.create(
        BicycleParams.create(), bicycle2d,
        neighbors=TE.NeighborConfig(cutoff=100.0, block=128,
                                    block_src=block_src, kb=40,
                                    backend=backend, rebuild_every=20))
    PF.reset_launches()
    # the eager loop: every step goes through the wrapper (the graphed
    # loop's counts are held in test_torch_graph.py)
    final, _ = eng.simulate(st, 25, record=False, graph=False)
    torch.cuda.synchronize()
    kernel = {"pallas": PF.pair_forces_neighbors,
              "pallas_unrolled": PF.pair_forces_neighbors_unrolled,
              "pallas_db": PF.pair_forces_neighbors_db}[backend]
    assert kernel.launches == 25
    assert sum(k.launches for k in PF.KERNELS) == 25
    assert torch.isfinite(final.s).all()
    assert not eng.neighbor_cache(final)[3].any()
