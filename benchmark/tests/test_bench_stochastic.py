"""The reference of the stochastic balancing rider
(`reference/models/balancingrider_stochastic.py`) against the port on the
CPU: its draws of pole features against the port's `PoleModelRT` on the
same per-rider keys, its Ackermann basis against the port's fit, and its
whole step against the port's engine in float64 over 50 steps, from the
episode's start and from a later state of the port's in which riders
have drawn again. The reference itself imports nothing of the port."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import random as rnd
from benchmark.reference import step as R
from benchmark.reference import whipple
from benchmark.reference.models import balancingrider_stochastic as S

CONFIG = harness.BENCH / "configs" / "balancingrider_stochastic.json"
# steps from the start; steps before the later start; steps from it
START, LATER, AGAIN = 50, 80, 50


def config(dtype="float64"):
    cfg = harness.load_json(CONFIG)
    cfg["dtype"] = dtype
    return cfg


def program_pole_model(cfg):
    from cyclistsocialforce_tpu_torch import behavior

    return behavior.PoleModelRT.from_polemodel(
        behavior.load_packaged_polemodel(
            cfg["create"]["controlparam_filename"]))


@pytest.mark.parametrize("dtype, rel, flips", [("float64", 1e-7, 0),
                                               ("float32", 1e-4, 10)])
def test_draws_follow_the_port(dtype, rel, flips):
    """The conditioning, the component choice, the Cholesky draw, the
    inverse transforms and the rejection rounds, on 100,000 riders' keys
    at speeds over the whole band, each rider's features within `rel` of
    the port's (relative, below 1e-3 absolute) but for at most `flips`
    riders. In float64 the normals' erfinv differs by ~1e-12, which the
    inverse Yeo-Johnson amplifies near the edge of its domain (features
    of several hundred): 1e-7, and no rider picks another round or
    component. In float32 the port conditions in float32, the reference
    in float64 on float32 draws: a uniform within rounding of a
    cumulative weight, or a real part within rounding of 0, may pick
    another component or round for about one rider in 100,000."""
    cfg = config(dtype)
    dt = getattr(torch, dtype)
    n = 100_000
    v = torch.linspace(-0.5, 10.0, n, dtype=torch.float64)
    keys = rnd.stream(rnd.prng_key(0), torch.tensor(37, dtype=torch.int32),
                      torch.arange(n, dtype=torch.int32), S.SALT_STEP)
    pm = S.pole_model(cfg["create"]["controlparam_filename"], torch.float64,
                      "cpu")
    ours = S.sample(pm, keys, v, dt)
    theirs, passed = program_pole_model(cfg).to(dt).sample_features_batch(
        keys, v.to(dt))
    gap = ((theirs.double() - ours).abs()
           / ours.abs().clamp_min(1e-3)).amax(dim=1)
    assert int((gap > rel).sum()) <= flips
    # every draw passed within its rounds, and the features are stable
    assert bool(passed.all())
    assert bool(S.stable(pm, ours).all())


def test_fallback_is_the_most_likely_mean(monkeypatch):
    """A rider whose 8 rounds all fail takes the conditional mean of its
    most likely component, as the port's rider does."""
    cfg = config()
    pm = S.pole_model(cfg["create"]["controlparam_filename"], torch.float64,
                      "cpu")
    v = torch.tensor([2.0, 4.5], dtype=torch.float64)
    monkeypatch.setattr(S, "stable", lambda pm, f: torch.zeros(
        f.shape[:-1], dtype=torch.bool))
    keys = rnd.stream(rnd.prng_key(0), 5, torch.arange(2), S.SALT_STEP)
    got = S.sample(pm, keys, v, torch.float64)
    means, w = S.conditional(pm, v)
    want = S.to_features(pm, means[torch.arange(2), w.argmax(dim=1)])
    assert torch.equal(got, want)


def test_basis_fit_worked_out_again():
    from cyclistsocialforce_tpu_torch.params import BalancingRiderParams

    create = config()["create"]
    prog = BalancingRiderParams.create(**create)
    mats = whipple.system_matrices(create["bicycle_parameter_dict"])
    coeffs, lo, seg = whipple.fit_poly(
        lambda v: S.ackermann_basis(mats, v).reshape(len(v), 30), 10.0,
        create["gains_poly"])
    theirs, t_lo, t_seg = prog.br_ackermann_poly
    assert (lo, seg) == (t_lo, t_seg)
    theirs = np.asarray(theirs).reshape(coeffs.shape)
    assert np.allclose(coeffs, theirs, rtol=1e-8,
                       atol=1e-8 * np.abs(theirs).max())


def test_reference_follows_the_port_in_float64():
    torch.set_num_threads(4)
    cfg = config()
    cfg["neighbors"].update(cutoff=400.0, kb=64)
    mix = harness.load_json(harness.BENCH / "traffic" / "dense_100k.json")
    inputs = harness.generate({**mix, "n_riders": 256}, 3)
    engine, state = harness.build_program(cfg, inputs, "cpu")
    model = R.reference_model(cfg)
    c = R.constants(cfg, torch.float64, "cpu")
    ref = R.initial_state(cfg, c, inputs["s0"], inputs["dest"],
                          inputs["n_riders"], torch.float64, "cpu")
    # the start: the port's prepared state is the reference's own
    start = harness.reference_input(state, torch.float64, model)
    assert set(ref) == set(start)
    for key in ("key", "uid", "t_glob", "s", "dyn_x"):
        assert torch.equal(start[key], ref[key]), key
    scale = ref["dyn_gains"].abs().amax(dim=1, keepdim=True)
    assert float(((start["dyn_gains"] - ref["dyn_gains"]).abs()
                  / scale).max()) < 1e-8
    out, _ = engine.simulate(state, START, record=False)
    want = R.run(ref, c, START)
    act = want["active"]
    assert int(want["t_glob"]) == int(out.t_glob) == START
    assert float((out.s[act] - want["s"][act]).abs().max()) < 1e-8
    # riders drew again within the steps compared
    drew = out.dyn_gains[act, 10] != state.dyn_gains[act, 10]
    assert int(drew.sum()) > 10
    assert torch.equal(drew, want["dyn_gains"][act, 10]
                       != ref["dyn_gains"][act, 10])
    # and from the port's state later on, as the check follows it
    later, _ = engine.simulate(out, LATER, record=False)
    again = R.run(harness.reference_input(later, torch.float64, model), c,
                  AGAIN)
    out2, _ = engine.simulate(later, AGAIN, record=False)
    assert float((out2.s[act] - again["s"][act]).abs().max()) < 1e-8
    assert float((out2.dyn_gains[act] - again["dyn_gains"][act]).abs()
                 .max()) < 1e-8
    assert int((out2.dyn_gains[act, 10] != later.dyn_gains[act, 10]).sum()) > 0
    assert int(again["t_glob"]) == int(out2.t_glob)


def test_reference_imports_no_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.step, benchmark.reference.random, "
            "benchmark.reference.models.balancingrider_stochastic; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cyclistsocialforce_tpu', "
            "'cyclistsocialforce_tpu_torch')); print(bad); "
            "sys.exit(1 if bad else 0)" % str(harness.ROOT))
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
