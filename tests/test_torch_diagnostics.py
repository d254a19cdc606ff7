"""PyTorch port: the diagnostics (`diagnostics.py`), the four cases of
tests/test_diagnostics.py: the checked step and the checked run (explicit
torch checks, read back once a run, that name the first failing step),
and `validate_state`; besides, the checked run against the JAX package's
checkify run and the overflow check, and `trace` writing a profile.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch import engine as TE  # noqa: E402
from cyclistsocialforce_tpu_torch.diagnostics import (  # noqa: E402
    CheckFailed, checked_simulate, checked_step, trace,
    validate_state)
from cyclistsocialforce_tpu_torch.models import MODELS, prepare  # noqa: E402
from cyclistsocialforce_tpu_torch.params import (  # noqa: E402
    BicycleParams, as_population)
from cyclistsocialforce_tpu_torch.state import (make_state,  # noqa: E402
                                                set_destinations)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
S0 = np.array([[0.0, 0, 0, 4, 0], [4.0, 1, 0, 4, 0]])


@pytest.fixture
def jx():
    """The JAX package's modules used as the reference."""
    pytest.importorskip("jax")
    import jax

    from cyclistsocialforce_tpu import diagnostics, engine, make_state
    from cyclistsocialforce_tpu import params
    from cyclistsocialforce_tpu.models import MODELS as JMODELS
    from cyclistsocialforce_tpu.models import prepare as jprepare
    from cyclistsocialforce_tpu.state import set_destinations as jset

    return types.SimpleNamespace(jax=jax, JD=diagnostics, JE=engine,
                                 JP=params, make_state=make_state,
                                 MODELS=JMODELS, prepare=jprepare,
                                 set_destinations=jset)


def _setup(bad=False, neighbors=None):
    """tests/test_diagnostics.py's two riders; `bad` puts a NaN into
    rider 1's x."""
    st = make_state(S0, dtype=torch.float64, device=DEV)
    st = set_destinations(st, 0, (40.0,), (0.0,))
    st = set_destinations(st, 1, (44.0,), (1.0,))
    p = as_population(BicycleParams.create(), 2, device=DEV)
    model = MODELS["bicycle2d"]
    st = prepare(model, p, st)
    if bad:
        s = st.s.clone()
        s[1, 0] = float("nan")
        st = st.replace(s=s)
    return TE.Engine.create(p, model, neighbors=neighbors), st


def test_checked_step_clean():
    eng, st = _setup()
    err, new = checked_step(eng)(st)
    err.throw()   # no error
    assert err.get() is None
    assert torch.isfinite(new.s).all()
    assert torch.equal(new.s, eng.step(st).s)


def test_checked_step_raises_on_nan():
    eng, st = _setup(bad=True)
    err, _ = checked_step(eng)(st)
    with pytest.raises(CheckFailed, match="non-finite"):
        err.throw()


def test_checked_simulate_reports_step_index(jx):
    """A clean 50-step run: no error, [50, 2, 8] records equal to the
    JAX package's checked run; a NaN from the start: an error naming step
    0, as JAX's does."""
    eng, st = _setup()
    err, (final, traj) = checked_simulate(eng, 50)(st)
    err.throw()
    assert traj.shape == (50, 2, 8)
    assert torch.equal(traj, eng.simulate(st, 50)[1])

    jst = jx.make_state(S0, dtype=np.float64)
    jst = jx.set_destinations(jst, 0, (40.0,), (0.0,))
    jst = jx.set_destinations(jst, 1, (44.0,), (1.0,))
    jp = jx.JP.as_population(jx.JP.BicycleParams.create(), 2)
    jmodel = jx.MODELS["bicycle2d"]
    jst = jx.prepare(jmodel, jp, jst)
    jerr, (_, jtraj) = jx.jax.jit(jx.JD.checked_simulate(
        jx.JE.Engine.create(jp, jmodel), 50))(jst)
    jerr.throw()
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-12)

    eng2, st2 = _setup(bad=True)
    err2, _ = checked_simulate(eng2, 50)(st2)
    with pytest.raises(CheckFailed, match="step 0"):
        err2.throw()


@pytest.mark.parametrize("at", [7, 23])
def test_checked_simulate_names_the_injected_step(at):
    """A model step that turns rider 0's y into NaN when its step counter
    reaches `at`: the run's error names that step (the checks note steps
    on the device, the run reads them once), and every record before it
    is finite."""
    eng, st = _setup()
    model = MODELS["bicycle2d"]

    def poisoned(params, state, fx, fy):
        new = model.step(params, state, fx, fy)
        s = new.s.clone()
        s[0, 1] = torch.where(state.i[0] == at, float("nan"), s[0, 1])
        return new.replace(s=s)

    eng.model_step = poisoned
    err, (_, traj) = checked_simulate(eng, 40)(st)
    with pytest.raises(CheckFailed, match=f"non-finite state at step {at}"):
        err.throw()
    assert torch.isfinite(traj[:at]).all()
    assert not torch.isfinite(traj[at]).all()


def test_checked_simulate_reports_table_overflow():
    """A neighbor table too small for the crowd is reported at the first
    step that builds it."""
    eng, st = _setup(neighbors=TE.NeighborConfig(cutoff=100.0, block=8,
                                                 kb=1))
    err, _ = checked_simulate(eng, 3)(st)
    assert err.get() is None
    rng = np.random.default_rng(0)
    s0 = np.zeros((64, 5))
    s0[:, :2] = rng.uniform(0, 40, (64, 2))
    s0[:, 3] = 4.0
    crowd = make_state(s0, dtype=torch.float64, device=DEV)
    tight = TE.Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                             neighbors=TE.NeighborConfig(cutoff=100.0,
                                                         block=8, kb=1))
    err, _ = checked_simulate(tight, 3)(crowd)
    with pytest.raises(CheckFailed, match="overflow at step 0"):
        err.throw()


def test_validate_state():
    _, st = _setup()
    assert validate_state(st) == []
    s = st.s.clone()
    s[0, 2] = float("inf")
    znav = st.znav.clone()
    znav[1] = True
    problems = validate_state(st.replace(s=s, znav=znav))
    assert any("non-finite" in p for p in problems)
    assert any("FSM" in p for p in problems)
    nq = st.nq.clone()
    nq[0] = st.queue_size + 1
    assert "queue length beyond capacity" in validate_state(
        st.replace(nq=nq))


def test_trace_writes_a_profile(tmp_path):
    """`trace` profiles a block of steps and writes a TensorBoard trace
    into the directory it names."""
    eng, st = _setup()
    with trace(str(tmp_path / "prof")) as logdir:
        eng.simulate(st, 3)
    files = list((tmp_path / "prof").iterdir())
    assert logdir == str(tmp_path / "prof") and files
    assert files[0].name.endswith(".pt.trace.json")
