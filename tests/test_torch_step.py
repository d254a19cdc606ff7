"""PyTorch port: destination force with the navigation FSM, the bicycle2d
step and the step bookkeeping, held to the JAX package at float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu import engine as JE  # noqa: E402
from cyclistsocialforce_tpu import make_state as jax_make_state  # noqa: E402
from cyclistsocialforce_tpu import params as JP  # noqa: E402
from cyclistsocialforce_tpu.models import bicycle2d as jbike  # noqa: E402
from cyclistsocialforce_tpu.state import set_destinations  # noqa: E402
from cyclistsocialforce_tpu_torch import convert  # noqa: E402
from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.models import bicycle2d  # noqa: E402

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
ATOL = 1e-12


def close(got, want, name, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


def fsm_state(n=512, seed=5):
    """Agents spread over every navigation-FSM state, with queue pointers,
    stop flags, speeds and distances on both sides of every threshold."""
    rng = np.random.default_rng(seed)
    q = 4
    s0 = np.zeros((n, 5))
    s0[:, 0:2] = rng.uniform(-20, 20, (n, 2))
    s0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    s0[:, 3] = rng.choice([0.0, 0.3, 0.6, 1.5, 2.5, 5.0], n)
    st = jax_make_state(s0, queue_size=q, hist_len=8, dtype=jnp.float64)
    # queue points at distances from 0.5 m (inside d_arrived) to 30 m
    r = rng.choice([0.5, 1.9, 2.1, 4.0, 8.0, 30.0], (n, q))
    ang = rng.uniform(-np.pi, np.pi, (n, q))
    dq = np.stack([s0[:, :1] + r * np.cos(ang), s0[:, 1:2] + r * np.sin(ang),
                   (rng.uniform(size=(n, q)) < 0.5).astype(float)], axis=2)
    nq = rng.integers(1, q + 1, n)
    ptr = rng.integers(0, q, n) % nq
    dest = dq[np.arange(n), ptr]
    znav = np.eye(3, dtype=bool)[rng.integers(0, 3, n)]
    latched = np.stack([rng.uniform(0, 6, n), rng.uniform(0.5, 5, n),
                        rng.uniform(0.1, 3, n), rng.integers(0, 50, n)],
                       axis=1)
    znavparams = np.where(znav[:, :1], 0.0, latched)
    return st.replace(
        destqueue=jnp.asarray(dq), dest=jnp.asarray(dest),
        nq=jnp.asarray(nq, jnp.int32), destpointer=jnp.asarray(ptr, jnp.int32),
        znav=jnp.asarray(znav), znavparams=jnp.asarray(znavparams),
        i=jnp.asarray(rng.integers(0, 100, n), jnp.int32),
        i_stopsignal=jnp.asarray(rng.integers(0, 100, n), jnp.int32),
        d_stopsignal=jnp.asarray(rng.uniform(0, 10, n)))


@pytest.mark.parametrize("per_agent", [False, True])
def test_dest_force_straight_fsm_matches_jax(per_agent):
    jst = fsm_state()
    jp = JP.BicycleParams.create()
    if per_agent:
        jp = JP.as_population(jp, jst.n)
    tst = convert.state_from_jax(jst, DEV)
    tp = convert.params_from_jax(jp, DEV)
    jfx, jfy, jnew = JE.dest_force_straight(jp, jst)
    tfx, tfy, tnew = TE.dest_force_straight(tp, tst)
    close(tfx, jfx, "fx")
    close(tfy, jfy, "fy")
    for f in ("dest", "destpointer", "znav", "znavparams", "i_stopsignal",
              "d_stopsignal"):
        close(getattr(tnew, f), getattr(jnew, f), f)
    # every FSM state is entered and every queue branch taken
    z_in, z_out = np.asarray(jst.znav), tnew.znav.numpy()
    for a in range(3):
        for b in range(3):
            if (a, b) in ((2, 0), (2, 1)):
                continue          # "arrived" holds while the flag holds
            assert np.any(z_in[:, a] & z_out[:, b]), (a, b)
    ptr_in = np.asarray(jst.destpointer)
    assert np.any(tnew.destpointer.numpy() > ptr_in)
    assert np.any(tnew.i_stopsignal.numpy() != np.asarray(jst.i_stopsignal))


def test_bicycle2d_step_matches_jax():
    rng = np.random.default_rng(8)
    jst = fsm_state(seed=9)
    n = jst.n
    s = np.asarray(jst.s).copy()
    s[:, 4] = rng.uniform(-1.5, 1.5, n)             # steer beyond delta_max
    s[:, 3] = rng.uniform(-2.0, 12.0, n)            # speed beyond limits
    jst = jst.replace(s=jnp.asarray(s),
                      pid_e=jnp.asarray(rng.normal(size=(n, 2))),
                      pid_i=jnp.asarray(rng.normal(size=(n, 2))))
    fx = rng.normal(size=n) * 6
    fy = rng.normal(size=n) * 6
    fx[:8] = -s[:8, 3] * np.cos(s[:8, 2])            # force opposite heading
    fy[:8] = -s[:8, 3] * np.sin(s[:8, 2])
    jp = JP.BicycleParams.create()
    want = jbike.step(jp, jst, jnp.asarray(fx), jnp.asarray(fy))
    got = bicycle2d.step(convert.params_from_jax(jp, DEV),
                         convert.state_from_jax(jst, DEV),
                         torch.from_numpy(fx), torch.from_numpy(fy))
    for f in ("s", "pid_e", "pid_i"):
        close(getattr(got, f), getattr(want, f), f)


def test_finish_step_matches_jax():
    rng = np.random.default_rng(2)
    before = fsm_state(n=64, seed=3)
    n = before.n
    active = rng.uniform(size=n) < 0.7
    before = before.replace(active=jnp.asarray(active),
                            t_glob=jnp.asarray(13, jnp.int32))
    new = before.replace(s=before.s + 0.25, pid_e=before.pid_e - 1.0,
                         znav=~before.znav, destpointer=before.destpointer + 1)
    jeng = JE.Engine.create(JP.BicycleParams.create(), jbike)
    want = jeng.finish_step(before, new)
    teng = TE.Engine.create(convert.params_from_jax(jeng.params, DEV),
                            bicycle2d, rep_force="twod",
                            neighbors=TE.NeighborConfig())
    got = teng.finish_step(convert.state_from_jax(before, DEV),
                           convert.state_from_jax(new, DEV))
    gotn = convert.state_to_numpy(got)
    for f in gotn:
        close(gotn[f], getattr(want, f), f, atol=0)


def test_stop_destinations_scenario_matches_jax():
    """The 3-agent encroachment scenario with stop destinations (agents 1
    and 2 brake to a halt, agent 0 keeps cruising), run through both
    engines' whole culled step for 2,000 steps."""
    s0 = np.array([[-6., 0, 0, 5, 0], [15., -20, np.pi / 2, 5, 0],
                   [13., -20, np.pi / 2, 5, 0]])
    jst = jax_make_state(s0, dtype=jnp.float64, hist_len=8)
    jst = set_destinations(jst, 0, (35, 64, 65), (0, 0, 0))
    jst = set_destinations(jst, 1, (15, 15, 15), (20, 49, 50), stop=(0, 0, 1))
    jst = set_destinations(jst, 2, (13, 13, 13), (20, 49, 50), stop=(0, 0, 1))
    jp = JP.BicycleParams.create()
    cfg = dict(cutoff=1e4, block=8, kb=1)
    jeng = JE.Engine.create(jp, jbike, rep_force="twod",
                            neighbors=JE.NeighborConfig(backend="xla", **cfg))
    want, _ = jax.jit(lambda e, s: e.simulate(s, 2000, record=False))(
        jeng, jst)
    teng = TE.Engine.create(convert.params_from_jax(jp, DEV), bicycle2d,
                            rep_force="twod",
                            neighbors=TE.NeighborConfig(screen=False, **cfg))
    got, _ = teng.simulate(convert.state_from_jax(jst, DEV), 2000,
                           record=False)
    np.testing.assert_array_equal(got.znav.numpy(),
                                  [[True, False, False],
                                   [False, False, True],
                                   [False, False, True]])
    assert got.s[1:, 3].abs().max() < 0.6          # stopped
    for f in ("s", "dest", "destpointer", "znav", "znavparams",
              "i_stopsignal", "d_stopsignal", "i", "pos_hist"):
        close(getattr(got, f), getattr(want, f), f, atol=1e-9)
