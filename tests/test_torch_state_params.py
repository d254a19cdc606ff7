"""PyTorch port: state, parameters, conversion and the population builder
held to the JAX package, field by field, at float64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from __graft_entry__ import _build  # noqa: E402
from cyclistsocialforce_tpu import make_state as jax_make_state  # noqa: E402
from cyclistsocialforce_tpu import params as JP  # noqa: E402
from cyclistsocialforce_tpu.models import MODELS as JMODELS  # noqa: E402
from cyclistsocialforce_tpu_torch import convert, scenarios  # noqa: E402
from cyclistsocialforce_tpu_torch import params as TP  # noqa: E402
from cyclistsocialforce_tpu_torch.models import MODELS  # noqa: E402
from cyclistsocialforce_tpu_torch.state import (AgentState,  # noqa: E402
                                                make_state)

torch.set_num_threads(1)

DEV = "cpu"   # the port's entry points default to the card
STATE_FIELDS = [f.name for f in dataclasses.fields(AgentState)]


def assert_state_equal(port_state, jax_state):
    got = convert.state_to_numpy(port_state)
    # the key's two uint32 words are int64 in the port
    got["key"] = got["key"].astype(np.uint32)
    for f in STATE_FIELDS:
        want = np.asarray(getattr(jax_state, f))
        assert got[f].shape == want.shape, f
        assert got[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got[f], want, err_msg=f)


@pytest.mark.parametrize("k,kw", [
    (5, {}),
    (4, {"queue_size": 4, "hist_len": 3}),
    (8, {"v_max_walk": 3.0}),
    (5, {"model": "bicycle2d"}),
])
def test_make_state_matches_jax(k, kw):
    rng = np.random.default_rng(3)
    s0 = rng.normal(size=(37, k)) * [50, 50, 6, 3, 1, 1, 1, 1][:k]
    jkw, tkw = dict(kw), dict(kw)
    if "model" in kw:
        jkw["model"] = JMODELS[kw["model"]]
        tkw["model"] = MODELS[kw["model"]]
    want = jax_make_state(s0, dtype=jnp.float64, **jkw)
    got = make_state(s0, dtype=torch.float64, device=DEV, **tkw)
    assert_state_equal(got, want)
    # the JAX round trip through numpy gives the same tensors
    assert_state_equal(convert.state_from_jax(want, DEV), want)


def test_state_replace_and_to():
    st = make_state(np.zeros((3, 4)), dtype=torch.float64, device=DEV)
    st2 = st.replace(nq=st.nq + 2)
    assert st.nq.tolist() == [1, 1, 1] and st2.nq.tolist() == [3, 3, 3]
    moved = st2.to("cpu")
    assert moved.s.device.type == "cpu" and moved.n == 3
    assert moved.hist_len == 128 and moved.queue_size == 16


def _params_equal(port, jax_p):
    for f in dataclasses.fields(type(port)):
        got = getattr(port, f.name)
        if isinstance(got, dict):      # an external model's parameter slot
            assert got == TP.param_dict(f.name, getattr(jax_p, f.name)), \
                f.name
            continue
        want = np.asarray(getattr(jax_p, f.name))
        got = np.asarray(got.numpy() if isinstance(got, torch.Tensor)
                         else got, dtype=np.float64)
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("cls,kw", [
    ("BicycleParams", {}),
    ("BicycleParams", {"hfov": 2 * np.pi, "v_desired_default": 4.0,
                       "l": 1.2, "l_1": 0.4}),
    ("BicycleParams", {"e_0": 0.5, "e_1": 0.6, "calib_mode": True,
                       "verbose": False}),
    ("VehicleParams", {"sigma_2": 0.7, "calib_mode": True,
                       "verbose": False}),
])
def test_params_create_matches_jax(cls, kw):
    want = getattr(JP, cls).create(**kw)
    got = getattr(TP, cls).create(**kw)
    _params_equal(got, want)
    _params_equal(convert.params_from_jax(want, DEV), want)


@pytest.mark.parametrize("kw", [{"e_0": 1.5}, {"sigma_3": 6.0},
                                {"a_max": (1.0, 2.0)}, {"hfov": 0.0},
                                {"l": None, "l_1": None, "l_2": None}])
def test_params_validation_rejects_like_jax(kw):
    with pytest.raises((ValueError, AssertionError)):
        JP.BicycleParams.create(**kw)
    with pytest.raises(ValueError):
        TP.BicycleParams.create(**kw)


def test_as_population_and_pairs_match_jax():
    n = 5
    want = JP.as_population(JP.BicycleParams.create(), n)
    got = TP.as_population(TP.BicycleParams.create(), n, DEV)
    _params_equal(got, want)
    _params_equal(convert.params_from_jax(want, DEV), want)
    for f in ("a_max", "a_desired_default", "v_max_riding"):
        np.testing.assert_array_equal(
            TP.pair_lo(getattr(got, f)).numpy(),
            np.asarray(JP.pair_lo(getattr(want, f))))
        np.testing.assert_array_equal(
            TP.pair_hi(getattr(got, f)).numpy(),
            np.asarray(JP.pair_hi(getattr(want, f))))
    shared = TP.BicycleParams.create()
    assert TP.pair_lo(shared.a_max) == -10.0
    assert TP.pair_hi(shared.v_max_riding) == 10.0


@pytest.mark.parametrize("n,density,pad", [(1000, 0.02, 128),
                                           (300, None, None)])
def test_build_population_matches_graft_build(n, density, pad):
    """Draw-for-draw reproduction of `__graft_entry__._build` (1000 pads
    to 1024: the 24 inactive pad rows are covered)."""
    _, want = _build(n, dtype=np.float64, density=density, hist_len=8,
                     pad_to_block=pad)
    got = scenarios.build_population(n, density, 8, pad, torch.float64, DEV)
    assert_state_equal(got, want)
    if pad:
        assert got.n == 1024 and int(got.active.sum()) == n


def test_package_never_imports_jax():
    """The port runs where JAX is absent: no module of the package, and
    not chip_smoke.py, may import it."""
    import ast
    import pathlib

    import cyclistsocialforce_tpu_torch

    root = pathlib.Path(cyclistsocialforce_tpu_torch.__file__).parent
    for path in [*root.rglob("*.py"), root.parent / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert not name.split(".")[0] in ("jax", "jaxlib", "flax"), \
                    f"{path} imports {name}"
                assert not name.startswith("cyclistsocialforce_tpu.") \
                    and name != "cyclistsocialforce_tpu", \
                    f"{path} imports the JAX package ({name})"


def test_ops_never_import_higher_modules():
    """The kernels' layer decides nothing by model: no module under ops/
    imports the engine, the models, the mixed engine or the scenarios, at
    any depth (inside a function too)."""
    import ast
    import pathlib

    import cyclistsocialforce_tpu_torch

    pkg = pathlib.Path(cyclistsocialforce_tpu_torch.__file__).parent
    higher = tuple(f"cyclistsocialforce_tpu_torch.{m}" for m in (
        "engine", "models", "mixed", "scenario", "scenarios"))
    for path in (pkg / "ops").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            for name in names:
                assert not any(name == h or name.startswith(h + ".")
                               for h in higher), f"{path} imports {name}"



def test_package_imports_without_optional_modules():
    """Every module of the port imports with matplotlib, yaml, cv2 and
    sklearn absent (as on the card's machine): a subprocess blocks them
    (`sys.modules[name] = None`) and imports each module."""
    import pathlib
    import subprocess
    import sys

    import cyclistsocialforce_tpu_torch

    root = pathlib.Path(cyclistsocialforce_tpu_torch.__file__).parent
    mods = sorted(
        ".".join(("cyclistsocialforce_tpu_torch",)
                 + path.relative_to(root).with_suffix("").parts)
        .removesuffix(".__init__")
        for path in root.rglob("*.py"))
    code = ("import importlib, sys\n"
            "for name in ('matplotlib', 'yaml', 'cv2', 'sklearn', 'jax'):\n"
            "    sys.modules[name] = None\n"
            f"for mod in {mods!r}:\n"
            "    importlib.import_module(mod)\n"
            "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root.parent, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "cyclistsocialforce_tpu_torch.viz" in mods
    assert "cyclistsocialforce_tpu_torch.sumo.bridge" in mods
