"""PyTorch port: every single-family form of the three pair kernels
(`ops/pair_forces.py`: K1 with its screens, FOV-off, per-source-column and
priority-to-the-right forms, K2 unrolled, K3 double-buffered) and the
`NeighborConfig(backend, screen, sub)` routing, held to the JAX package's
Pallas kernels (interpret mode), its XLA oracle and its `Engine.simulate`;
the CUDA kernels held to their plain versions where a card is present.

The JAX package comes in through the `jx` fixture, so the card's tests
also run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_pair_variants.py
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

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
BLOCK = 128
# the JAX package's float32 bar for its Pallas kernels against its float64
# oracle (tests/test_neighbors.py): |port - JAX| <= ATOL + RTOL |JAX|
ATOL, RTOL = 1e-4, 2e-4

# form -> (kernel, block_src, population, options). Populations: "uniform"
# (shared field parameters, FOV cone on), "columns" (per-agent field
# parameters: the per-source-column form), "full_fov" (hfov = 2 pi: the
# cone test elided).
FORMS = {
    "k1_screen": ("k1", 64, "uniform", {"screen": True}),
    "k1_screen_sub32": ("k1", 64, "uniform", {"screen": True, "sub": 32}),
    "k1_fov_off": ("k1", 64, "full_fov", {}),
    "k1_columns": ("k1", 64, "columns", {}),
    "k1_p2r": ("k1", 64, "uniform", {"priority_p2r": True}),
    "k1_columns_p2r": ("k1", 64, "columns", {"priority_p2r": True}),
    "k1_columns_sub32": ("k1", 64, "columns", {"screen": True, "sub": 32}),
    "k2_uniform": ("k2", 64, "uniform", {}),
    "k2_columns": ("k2", 64, "columns", {}),
    "k3": ("k3", 128, "columns", {}),
    "k3_p2r": ("k3", 128, "columns", {"priority_p2r": True}),
}
# the cutoff of the float32 comparisons, per kernel: one at which the
# screens of the crowd below skip tiles (K1's by up to 0.4 in a force, K3's
# at block_src = 128 only fringe tiles whose pairs lie near the cutoff)
SCREEN_CUTOFF = {"k1": 10.0, "k2": 10.0, "k3": 50.0}


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


def port_params(population, n, seed=0):
    """The port's BicycleParams for a population kind (see FORMS)."""
    if population == "full_fov":
        return BicycleParams.create(hfov=2 * np.pi)
    p = BicycleParams.create()
    if population == "uniform":
        return p
    rng = np.random.default_rng(seed)
    p = as_population(p, n, device=DEV)
    return p.replace(
        f_0=p.f_0 * torch.as_tensor(1 + 0.05 * rng.uniform(-1, 1, n)),
        sigma_0=p.sigma_0 * torch.as_tensor(1 + 0.05 * rng.uniform(-1, 1, n)))


def form_inputs(form, n, device, cutoff, kb=None, dtype=torch.float32,
                block=BLOCK):
    """(engine, sorted torch packs, kernel options) of one form on the
    port's bench-style crowd (0.02 /m^2, padded to the block). kb defaults
    to the number of source blocks, so the table never overflows."""
    kernel, block_src, population, opts = FORMS[form]
    st = build_population(n, 0.02, 8, block, dtype, device)
    kb = kb or st.n // block_src
    eng = TE.Engine.create(
        port_params(population, st.n), bicycle2d, rep_force="twod",
        neighbors=TE.NeighborConfig(cutoff=cutoff, block=block,
                                    block_src=block_src, kb=kb))
    cache = eng.neighbor_cache(st)
    assert not cache[3].any()
    src, recv = TE.sorted_packs(eng.pack_pair_fields(st)[0], cache[0])
    kw = dict(fov=not eng.full_fov, **opts)
    if kernel != "k3":
        kw.update(block_src=block_src, uniform=eng.uniform_pair)
    if kernel != "k2":
        kw.update(cutoff=cutoff)
    return eng, (cache[1], cache[2], src, recv), kw


PORT_KERNELS = {"k1": PF.pair_forces_neighbors,
                "k2": PF.pair_forces_neighbors_unrolled,
                "k3": PF.pair_forces_neighbors_db}


def plain_kwargs(kernel, kw):
    """The plain version's arguments for the form a kernel call runs."""
    kw = dict(kw)
    if kernel == "k3":
        kw.update(block_src=BLOCK, screen=True)
    return kw


def jax_form(jx, kernel, tensors, kw):
    """The JAX package's Pallas kernel of the form, interpret mode."""
    jn, jv, js, jr = (jx.jnp.asarray(a.cpu().numpy()) for a in tensors)
    common = dict(block=BLOCK, interpret=True, fov=kw["fov"],
                  priority_p2r=kw.get("priority_p2r", False))
    if kernel == "k1":
        return jx.JPF.pair_forces_neighbors(
            jn, jv, js, jr, cutoff=kw["cutoff"],
            screen=kw.get("screen", False), sub=kw.get("sub", 0),
            block_src=kw["block_src"], uniform=kw["uniform"], **common)
    if kernel == "k2":
        return jx.JPF.pair_forces_neighbors_unrolled(
            jn, jv, js, jr, block_src=kw["block_src"],
            uniform=kw["uniform"], **common)
    return jx.JPF.pair_forces_neighbors_db(jn, jv, js, jr,
                                           cutoff=kw["cutoff"], **common)


# ---- the fault: the default configuration screens --------------------------


def two_clusters():
    """16 riders in two clusters of 8, diagonal to each other: A on two
    short segments near (0, 1) and (1, 0), B the same shifted by (4, 4).
    Their bounding boxes are 4.24 m apart, every A-B pair 5.66-5.83 m.
    A rides towards B and B towards A, so each sees the other."""
    t = np.arange(4) / 3
    a = np.concatenate([np.stack([0.25 * t, 1 - 0.25 * t], 1),
                        np.stack([0.75 + 0.25 * t, 0.25 - 0.25 * t], 1)])
    s0 = np.zeros((16, 5))
    s0[:8, :2] = a
    s0[8:, :2] = a + 4.0
    s0[:8, 2] = np.pi / 4
    s0[8:, 2] = -3 * np.pi / 4
    s0[:, 3] = 5.0
    return s0


def test_default_config_screens_like_jax(jx):
    """With a 5 m cutoff the box-to-box table admits the other cluster's
    block, but none of its pairs lies within the cutoff. The JAX package's
    default NeighborConfig() screens (K1, tile screen at the cutoff) and
    takes nothing from that block; the port's default must do the same.
    Float32 on both sides (the JAX kernel runs in float32), at the JAX
    package's float32 bar."""
    s0 = two_clusters()
    d = np.hypot(*(s0[:8, None, :2] - s0[None, 8:, :2]).transpose(2, 0, 1))
    assert d.min() > 5.6
    jst = jx.make_state(s0, dtype=jx.jnp.float32, hist_len=8)
    jp = jx.JP.BicycleParams.create()
    cfg = dict(cutoff=5.0, block=8, kb=2)
    jeng = jx.JE.Engine.create(
        jp, jx.bicycle2d, rep_force="twod",
        neighbors=jx.JE.NeighborConfig(backend="interpret", **cfg))
    want = np.stack([np.asarray(f) for f in
                     jeng.repulsive_sum_neighbors(jst)])

    tp = convert.params_from_jax(jp, DEV)
    tst = convert.state_from_jax(jst, DEV)
    teng = TE.Engine.create(tp, bicycle2d, rep_force="twod",
                            neighbors=TE.NeighborConfig(**cfg))
    cache = teng.neighbor_cache(tst)
    assert cache[2].all()                      # the other block is admitted
    got = torch.stack(teng.repulsive_sum_neighbors(tst)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    unscreened = TE.Engine.create(
        tp, bicycle2d, rep_force="twod",
        neighbors=TE.NeighborConfig(screen=False, **cfg))
    loose = torch.stack(unscreened.repulsive_sum_neighbors(tst)).numpy()
    assert np.abs(loose - want).max() > 0.1   # the block's force is O(1)


def test_neighbor_config_defaults_and_checks():
    cfg = TE.NeighborConfig()
    assert (cfg.backend, cfg.screen, cfg.sub) == ("pallas", True, 0)
    for backend in ("interpret", "interpret_db", "pallas_fast"):
        with pytest.raises(ValueError, match="backend"):
            TE.NeighborConfig(backend=backend)
    with pytest.raises(ValueError, match="plain version"):
        TE.NeighborConfig(backend="interpret")
    # "xla" is the generic path of custom tiles: a named field refuses it
    # where the engine is built
    with pytest.raises(ValueError, match="plain version"):
        TE.Engine.create(BicycleParams.create(), bicycle2d,
                         rep_force="twod",
                         neighbors=TE.NeighborConfig(backend="xla"))
    with pytest.raises(ValueError, match="block_src != block"):
        TE.NeighborConfig(backend="pallas_db", block_src=64)
    TE.NeighborConfig(backend="pallas_db", block_src=128)
    TE.NeighborConfig(block_src=64, sub=32)
    for sub in (12, 48, -8):
        with pytest.raises(ValueError, match="sub"):
            TE.NeighborConfig(block_src=64, sub=sub)


# ---- each form: plain float32 vs the Pallas kernel, interpret mode --------


@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_f32_matches_pallas_interpret(jx, form):
    """The port's wrapper on CPU tensors (its plain version in the form)
    against the JAX package's kernel of the same form in interpret mode,
    on the same float32 packs (1,024 riders, 8 receiver blocks)."""
    kernel = FORMS[form][0]
    eng, tensors, kw = form_inputs(form, 1000, DEV,
                                   SCREEN_CUTOFF[kernel])
    want = np.asarray(jax_form(jx, kernel, tensors, kw))
    PF.reset_launches()
    got = PORT_KERNELS[kernel](*tensors, **kw).numpy()
    assert all(fn.launches == 0 for fn in PF.KERNELS)
    err = np.abs(got - want)
    print(f"{form}: max |diff| {err.max():.3e}, max |force| "
          f"{np.abs(want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(want).max() > 1.0            # real forces compared
    if kw.get("screen") or kernel == "k3":
        # the screen drops tiles (or strips) the table admitted
        loose = PF.pair_forces_neighbors_ref(
            *tensors, **{**plain_kwargs(kernel, kw), "screen": False})
        assert (loose.numpy() != got).any()


# ---- float64 against the XLA oracle ----------------------------------------


@pytest.mark.parametrize("form,cutoff", [
    ("k1_p2r", 50.0), ("k1_fov_off", 50.0), ("k2_columns", 50.0),
    # screened forms with a cutoff covering the domain: every tile passes
    ("k1_screen", 1e4), ("k1_screen_sub32", 1e4), ("k3", 1e4),
    ("k3_p2r", 1e4)])
def test_plain_f64_matches_xla_oracle(jx, form, cutoff):
    kernel, block_src, _, opts = FORMS[form]
    eng, tensors, kw = form_inputs(form, 1000, DEV, cutoff,
                                   dtype=torch.float64)
    jn, jv, js, jr = (jx.jnp.asarray(a.numpy()) for a in tensors)
    want = np.asarray(jx.JPF.pair_forces_neighbors_xla(
        jn, jv, js, jr, block=BLOCK, fov=kw["fov"], block_src=block_src,
        priority_p2r=opts.get("priority_p2r", False)))
    got = PORT_KERNELS[kernel](*tensors, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert np.abs(want).max() > 1.0


# ---- the slice as a whole ----------------------------------------------------


SLICE_N, SLICE_STEPS = 1000, 12
SLICE_FIELDS = ("s", "dest", "destpointer", "znav", "i", "pos_hist",
                "t_glob", "active", "uid")


@pytest.mark.parametrize("backend", ["pallas", "pallas_db"])
def test_simulate_p2r_per_agent_matches_jax(jx, backend):
    """`Engine.simulate`, 12 steps at float64 (two rebuild chunks and a
    tail), priority to the right, per-agent f_0 and sigma_0 (+-5%): the
    port against JAX `simulate` on its XLA backend, which never screens.
    "pallas" runs K1 unscreened at a 50 m cutoff; "pallas_db" (always
    screened) runs with a cutoff covering the domain and kb = the number
    of blocks, so that its screen admits every tile."""
    import jax

    from __graft_entry__ import _build

    _, jst = _build(SLICE_N, dtype=np.float64, density=0.02, hist_len=8,
                    pad_to_block=BLOCK)
    n = jst.s.shape[0]
    rng = np.random.default_rng(7)
    jp = jx.JP.as_population(jx.JP.BicycleParams.create(), n)
    jp = jp.replace(f_0=jp.f_0 * (1 + 0.05 * rng.uniform(-1, 1, n)),
                    sigma_0=jp.sigma_0 * (1 + 0.05 * rng.uniform(-1, 1, n)))
    if backend == "pallas":
        cfg = dict(cutoff=50.0, block=BLOCK, block_src=64, kb=16)
        port_cfg = dict(screen=False)
    else:
        cfg = dict(cutoff=1e4, block=BLOCK, kb=n // BLOCK)
        port_cfg = {}
    jeng = jx.JE.Engine.create(
        jp, jx.bicycle2d, rep_force="twod", priority_rule="p2r",
        neighbors=jx.JE.NeighborConfig(backend="xla", rebuild_every=5,
                                       **cfg))
    want, _ = jax.jit(lambda e, s: e.simulate(s, SLICE_STEPS,
                                              record=False))(jeng, jst)
    teng = TE.Engine.create(
        convert.params_from_jax(jp, DEV), bicycle2d, rep_force="twod",
        priority_rule="p2r",
        neighbors=TE.NeighborConfig(backend=backend, rebuild_every=5,
                                    **cfg, **port_cfg))
    assert teng.priority_p2r and teng.uniform_pair is None
    tst = build_population(SLICE_N, 0.02, 8, BLOCK, torch.float64, DEV)
    got, _ = teng.simulate(tst, SLICE_STEPS, record=False)
    for f in SLICE_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=f)
    # priority to the right changes the trajectory
    free = TE.Engine.create(teng.params, bicycle2d, rep_force="twod",
                            neighbors=teng.neighbors)
    other, _ = free.simulate(tst, SLICE_STEPS, record=False)
    assert (other.s - got.s).abs().max() > 1e-6


def test_with_params_refreshes_derived_fields():
    """`Engine.with_params` recomputes `uniform_pair` and `full_fov` (the
    kernels' compile-time forms) from the new parameters, as the JAX
    package's does (tests/test_neighbors.py)."""
    p = BicycleParams.create()
    eng = TE.Engine.create(p, bicycle2d, rep_force="twod",
                           priority_rule="p2r",
                           neighbors=TE.NeighborConfig())
    assert eng.uniform_pair is not None and not eng.full_fov
    p2 = p.replace(e_0=p.e_0 * 0.5, hfov=2.0 * np.pi)
    eng2 = eng.with_params(p2)
    assert eng2.uniform_pair[0] == pytest.approx(float(p2.e_0))
    assert eng2.full_fov
    assert eng2.priority_p2r and eng2.neighbors is eng.neighbors
    assert eng2.params is p2 and eng.params is p
    n = 8
    p3 = as_population(p, n, DEV)
    p3 = p3.replace(sigma_0=p3.sigma_0 * (1 + 0.1 * torch.arange(n)))
    assert eng.with_params(p3).uniform_pair is None


def test_create_priority_rule():
    p, cfg = BicycleParams.create(), TE.NeighborConfig()
    for rule, want in (("p2r", True), ("unregulated", False)):
        eng = TE.Engine.create(p, bicycle2d, rep_force="twod",
                               priority_rule=rule, neighbors=cfg)
        assert eng.priority_p2r is want


@pytest.mark.parametrize("backend,kernel", [
    ("pallas", "k1"), ("pallas_unrolled", "k2"), ("pallas_db", "k3")])
def test_dispatch_routes_backend_to_its_form(backend, kernel):
    """`pair_kernel_dispatch` calls the wrapper the backend names, in the
    JAX dispatch's form: K1 and K3 screen at the cutoff without the skin,
    K2 never screens, K3 reads the per-source columns."""
    st = build_population(600, 0.02, 8, BLOCK, torch.float64, DEV)
    block_src = 128 if backend == "pallas_db" else 64
    cfg = TE.NeighborConfig(cutoff=SCREEN_CUTOFF[kernel], block=BLOCK,
                            block_src=block_src, kb=st.n // block_src,
                            backend=backend, rebuild_every=20)
    eng = TE.Engine.create(BicycleParams.create(), bicycle2d,
                           rep_force="twod", priority_rule="p2r",
                           neighbors=cfg)
    cache = eng.neighbor_cache(st)
    src, recv = TE.sorted_packs(eng.pack_pair_fields(st)[0], cache[0])
    got = eng.pair_kernel_dispatch(cache[1], cache[2], src, recv)
    want = PF.pair_forces_neighbors_ref(
        cache[1], cache[2], src, recv, block=BLOCK, block_src=block_src,
        uniform=None if kernel == "k3" else eng.uniform_pair,
        priority_p2r=True, screen=kernel != "k2",
        cutoff=SCREEN_CUTOFF[kernel])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_reject_mixed_and_bad_inputs():
    """Every wrapper takes the mixed form (on this twod pack, family 0 on
    every row, it is the per-column form) but not with shared constants;
    bad shapes and strips raise."""
    _, tensors, kw = form_inputs("k2_uniform", 256, DEV, 50.0)
    _, db_tensors, db_kw = form_inputs("k3", 256, DEV, 50.0)
    bs = {"block_src": kw["block_src"]}
    for fn, t, fkw in ((PF.pair_forces_neighbors, tensors, bs),
                       (PF.pair_forces_neighbors_unrolled, tensors, bs),
                       (PF.pair_forces_neighbors_db, db_tensors,
                        {"cutoff": db_kw["cutoff"]})):
        np.testing.assert_array_equal(fn(*t, **fkw, mixed=True),
                                      fn(*t, **fkw))
    for fn in PF.KERNELS[:2]:
        with pytest.raises(ValueError, match="mixed"):
            fn(*tensors, mixed=True, uniform=kw["uniform"])
    with pytest.raises(ValueError, match="sub"):
        PF.pair_forces_neighbors(*tensors, **kw, screen=True, sub=24)
    nbr, valid, src, recv = tensors
    for fn in PF.KERNELS:
        with pytest.raises(ValueError, match="N_src"):
            fn(nbr, valid, src[:100], recv)


# ---- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_form_matches_plain(cuda_device, form):
    """Each form's CUDA kernel against its plain version at 20k riders,
    the bench configuration's cutoff and a kb of 40 (no overflow); its
    launch counter steps by one per call, the others stay."""
    kernel = FORMS[form][0]
    _, tensors, kw = form_inputs(form, 20_000, cuda_device, 50.0, kb=40)
    fn = PORT_KERNELS[kernel]
    before = [k.launches for k in PF.KERNELS]
    got = fn(*tensors, **kw)
    torch.cuda.synchronize()
    after = [k.launches for k in PF.KERNELS]
    assert [a - b for a, b in zip(after, before)] == [
        int(k is fn) for k in PF.KERNELS]
    want = PF.pair_forces_neighbors_ref(*tensors,
                                        **plain_kwargs(kernel, kw))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert want.abs().max() > 1.0


# K1's forms that take its cone loop (the FOV cone on, one family)
K1_CONE_FORMS = ("k1_screen", "k1_screen_sub32", "k1_columns", "k1_p2r",
                 "k1_columns_p2r", "k1_columns_sub32")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["k1_uniform", *K1_CONE_FORMS])
@pytest.mark.parametrize("block", [64, 128, 256])
def test_cuda_k1_cone_forms_match_plain_at_each_block(cuda_device, form,
                                                      block):
    """K1's cone loop in each of its forms (uniform and per-row, priority
    to the right on and off, the strip and tile screens on and off) at
    every receiver block, at 20k riders and the bench configuration's
    cutoff: within the kernels' bar of the plain version, the same bits
    on a second call, and `field_pairs` equal to `field_pairs_ref`."""
    key = "k2_uniform" if form == "k1_uniform" else form
    _, tensors, kw = form_inputs(key, 20_000, cuda_device, 50.0, kb=64,
                                 block=block)
    kw["block"] = block
    counter = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    got = PF.pair_forces_neighbors(*tensors, **kw, field_pairs=counter)
    torch.cuda.synchronize()
    want = PF.pair_forces_neighbors_ref(*tensors, **kw)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert want.abs().max() > 1.0
    assert torch.equal(PF.pair_forces_neighbors(*tensors, **kw), got)
    assert int(counter) == PF.field_pairs_ref(*tensors, **kw) > 0


@pytest.mark.cuda
def test_cuda_mixed_equals_columns_and_any_kb_is_taken(cuda_device):
    """`mixed` on an all-twod pack equals the per-column call bit for bit
    in K2 and K3, and in K1 where both walk every pair (no FOV cone); with
    the cone, K1's column form evaluates only the units the cone needs
    and sums in its own order, within the kernels' bar of the mixed
    form, and bit for bit its uniform form on columns that hold the
    shared constants. `mixed` with uniform constants raises; K2 takes a table of any
    length (it stages a long row in rounds)."""
    _, tensors, kw = form_inputs("k2_uniform", 20_000, cuda_device, 50.0,
                                 kb=40)
    _, db_tensors, db_kw = form_inputs("k3", 20_000, cuda_device, 50.0,
                                       kb=40)
    bs = {"block_src": kw["block_src"]}
    for fn, t, fkw in ((PF.pair_forces_neighbors, tensors,
                        {**bs, "fov": False}),
                       (PF.pair_forces_neighbors_unrolled, tensors, bs),
                       (PF.pair_forces_neighbors_db, db_tensors,
                        {"cutoff": db_kw["cutoff"]})):
        torch.testing.assert_close(fn(*t, **fkw, mixed=True), fn(*t, **fkw),
                                   rtol=0, atol=0)
    k1 = PF.pair_forces_neighbors
    torch.testing.assert_close(k1(*tensors, **bs, mixed=True),
                               k1(*tensors, **bs), atol=ATOL, rtol=RTOL)
    # K1's cone loop, uniform form against column form with every row's
    # columns holding the shared constants: bit for bit, with the strip
    # screen and without
    nbr, valid, src, recv = tensors
    same = src.clone()
    same[:, PF._E0:PF._CHF + 1] = torch.tensor(kw["uniform"],
                                               dtype=src.dtype)
    u = tuple(float(v) for v in same[0, PF._E0:PF._CHF + 1])
    for screen in ({}, {"screen": True, "sub": 32, "cutoff": 20.0}):
        torch.testing.assert_close(
            k1(nbr, valid, src, recv, **bs, **screen, uniform=u),
            k1(nbr, valid, same, recv, **bs, **screen), rtol=0, atol=0)
    for fn in PF.KERNELS[:2]:
        with pytest.raises(ValueError, match="mixed"):
            fn(*tensors, mixed=True, uniform=kw["uniform"])
    # 400 slots of 64 rows are 1.6 MB of tiles, 17 rounds: the table
    # repeated 10 times with every slot valid (an invalid slot holds
    # block 0, summed here like any other)
    nbr = tensors[0].repeat(1, 10)
    valid = torch.ones_like(tensors[1]).repeat(1, 10)
    got = PF.pair_forces_neighbors_unrolled(nbr, valid, *tensors[2:], **kw)
    want = PF.pair_forces_neighbors_ref(nbr, valid, *tensors[2:], **kw,
                                        chunk=8)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert want.abs().max() > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kernel", [
    ("pallas_unrolled", "k2"), ("pallas_db", "k3")])
def test_cuda_simulate_launches_backend_kernel(cuda_device, backend,
                                               kernel):
    st = build_population(4096, 0.02, 8, BLOCK, torch.float32, cuda_device)
    block_src = 128 if backend == "pallas_db" else 64
    eng = TE.Engine.create(
        BicycleParams.create(), bicycle2d, rep_force="twod",
        neighbors=TE.NeighborConfig(cutoff=50.0, block=BLOCK,
                                    block_src=block_src, kb=24,
                                    backend=backend, rebuild_every=20))
    PF.reset_launches()
    # the eager loop: every step goes through the wrapper (the graphed
    # loop's counts are held in test_torch_graph.py)
    final, _ = eng.simulate(st, 25, record=False, graph=False)
    torch.cuda.synchronize()
    assert PORT_KERNELS[kernel].launches == 25
    assert sum(k.launches for k in PF.KERNELS) == 25
    assert torch.isfinite(final.s).all()
    assert not eng.neighbor_cache(final)[3].any()
