"""PyTorch port: the nine demos (`cyclistsocialforce_tpu_torch.demos`) run
headless end to end on the CPU, each at tests/test_demos.py's arguments
with `--device cpu`, as a subprocess with PYTHONPATH=. that never imports
JAX. Each is checked by a line it prints; `demo_calibration` recovers
k_p_v = 10.0 as the JAX demo does (slow there, slow here)."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the demo's module run as __main__, then proof that JAX never loaded
RUNNER = ("import runpy, sys; sys.argv = sys.argv[1:]; "
          "runpy.run_module(sys.argv[0], run_name='__main__'); "
          "assert 'jax' not in sys.modules, 'jax imported'; "
          "print('jax not imported')")

DEMOS = [
    (["demo_standalone", "--model", "twod", "--t-end", "1.0"],
     "model=twod:"),
    (["demo_standalone", "--model", "balancingrider", "--t-end", "0.5"],
     "model=balancingrider:"),
    (["demo_parcours", "--t-end", "1.0"], "waypoints reached"),
    (["demo_curve", "--t-end", "1.0"], "final pos"),
    (["demo_sumo", "--bikes", "2", "--steps", "800"],
     "ran 800 steps; all vehicles finished: True"),
    (["demo_mixed_traffic", "--riders", "256", "--cars", "3",
      "--steps", "60"], "lateral shift near the car lane"),
    (["demo_polemodel", "--model", "PP0", "--out", "{tmp}/poles.png"],
     "wrote {tmp}/poles.png"),
    (["demo_scale", "--agents", "2048", "--steps", "20", "--backend",
      "xla"], "agent-steps/sec"),
    (["demo_sharded", "--agents", "2048", "--steps", "12", "--comm",
      "allgather", "--skip-check"], "demo_sharded: ok"),
]


def run_demo(args, tmp_path):
    args = [a.replace("{tmp}", str(tmp_path)) for a in args]
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "PYTHONPATH": ".", "MPLBACKEND": "Agg", "OMP_NUM_THREADS": "2"}
    return subprocess.run(
        [sys.executable, "-c", RUNNER,
         f"cyclistsocialforce_tpu_torch.demos.{args[0]}", *args[1:],
         "--device", "cpu"],
        capture_output=True, text=True, timeout=420, cwd=str(ROOT), env=env)


@pytest.mark.parametrize("cmd,expect", DEMOS,
                         ids=[" ".join(c[:3]) for c, _ in DEMOS])
def test_demo_runs(cmd, expect, tmp_path):
    out = run_demo(cmd, tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect.replace("{tmp}", str(tmp_path)) in out.stdout, out.stdout
    assert "jax not imported" in out.stdout


@pytest.mark.slow
def test_demo_calibration(tmp_path):
    out = run_demo(["demo_calibration"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "recovered 10.0" in out.stdout
    assert "jax not imported" in out.stdout


def test_demo_without_a_card_asks_for_the_cpu(tmp_path):
    """`--device cuda` (the default) on a machine without a card stops
    with a message; nothing falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m",
         "cyclistsocialforce_tpu_torch.demos.demo_parcours", "--t-end",
         "0.1"], capture_output=True, text=True, timeout=120,
        cwd=str(ROOT), env={"PATH": os.environ.get("PATH", "/usr/bin"),
                            "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
                            "PYTHONPATH": "."})
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
