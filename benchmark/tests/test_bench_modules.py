import subprocess
import sys
import types

import pytest

from benchmark import harness


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax",
                                  "cyclistsocialforce_tpu",
                                  "cyclistsocialforce_tpu.ops.forces"])
def test_forbidden_module_found(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_loaded() == [name.split(".")[0]]


def test_port_passes(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN_MODULES:
            monkeypatch.delitem(sys.modules, name)
    import cyclistsocialforce_tpu_torch  # noqa: F401
    import cyclistsocialforce_tpu_torch.engine  # noqa: F401

    assert harness.forbidden_loaded() == []


def test_reference_imports_no_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.step, benchmark.reference.dest_spline, "
            "benchmark.reference.models.twod, "
            "benchmark.reference.models.balancingrider; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cyclistsocialforce_tpu', "
            "'cyclistsocialforce_tpu_torch')); print(bad); "
            "sys.exit(1 if bad else 0)" % str(harness.ROOT))
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


def test_run_exits_nonzero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "bicycle2d-district-8k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
