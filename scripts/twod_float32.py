#!/usr/bin/env python3
"""How far the twod model's float32 run lies from its float64 run, in the
port and in the JAX package, on the CPU.

    python3 scripts/twod_float32.py [--n 1024] [--steps 45]

The crowd is `chip_smoke.py`'s parity_twod crowd (the bench crowd sized
for twod, four destinations per rider, the queue pointer at uid % 4) on
the main path's NeighborConfig, run `--steps` steps in float32 and in
float64 by the port (K1's plain version) and by the JAX package (its XLA
pair path; each precision in a process of its own, as JAX fixes x64 at
start). Prints one JSON line per pair of runs: per quantity the largest
per-rider distance and the riders beyond 1e-3 (`chip_smoke.py`'s
PARITY_TOL), and which rows of the queue pointer the riders beyond 1e-3 m
sit on (3: the last-destination spline).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def crowd(n, dtype):
    import chip_smoke as CS

    return CS.with_queues(CS.twod_crowd(n, dtype, "cpu"))


def run_port(n, steps, dtype):
    import chip_smoke as CS

    fin, _ = CS.make_twod_engine(kb=40).simulate(crowd(n, dtype), steps,
                                                  record=False)
    return fin.s.double().numpy()


def run_jax(n, steps, x64: bool, out: str):
    """One precision of the JAX package's run, written to `out` (.npy)."""
    import jax

    jax.config.update("jax_enable_x64", x64)
    import jax.numpy as jnp
    import torch

    from cyclistsocialforce_tpu import make_state
    from cyclistsocialforce_tpu.engine import Engine, NeighborConfig
    from cyclistsocialforce_tpu.models import MODELS
    from cyclistsocialforce_tpu.params import BicycleParams

    st = crowd(n, torch.float64 if x64 else torch.float32)
    js = make_state(st.s[:, :5].numpy(), hist_len=st.hist_len,
                    dtype=np.float64 if x64 else np.float32,
                    model=MODELS["twod"])
    js = js.replace(**{f: jnp.asarray(getattr(st, f).numpy()) for f in (
        "dest", "destqueue", "destpointer", "nq", "active")})
    cfg = NeighborConfig(cutoff=50.0, block=128, block_src=64, kb=40,
                         rebuild_every=20, screen=False, backend="xla")
    eng = Engine.create(BicycleParams.create(), MODELS["twod"],
                        neighbors=cfg)
    fin, _ = jax.jit(lambda e, s: e.simulate(s, steps, record=False))(eng,
                                                                      js)
    np.save(out, np.asarray(fin.s, dtype=np.float64))


def distances(a, b, ptr):
    d = np.abs(a - b)
    wrap = np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)
    per = {"pos": np.hypot(d[:, 0], d[:, 1]), "psi": wrap[:, 2],
           "v": d[:, 3], "delta": wrap[:, 4]}
    far = per["pos"] > 1e-3
    return {"max": {k: float(e.max()) for k, e in per.items()},
            "n_over_1e-3": {k: int((e > 1e-3).sum()) for k, e in per.items()},
            "queue_pointer_of_riders_over_1e-3_m": {
                int(p): int((ptr[far] == p).sum()) for p in np.unique(ptr)}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=45)
    ap.add_argument("--jax-run", choices=["32", "64"], help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.jax_run:
        run_jax(args.n, args.steps, args.jax_run == "64", args.out)
        return 0

    import tempfile

    import torch

    torch.set_num_threads(4)
    runs = {"port32": run_port(args.n, args.steps, torch.float32),
            "port64": run_port(args.n, args.steps, torch.float64)}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for bits in ("32", "64"):
            out = str(Path(tmp) / f"jax{bits}.npy")
            subprocess.run([sys.executable, __file__, "--n", str(args.n),
                            "--steps", str(args.steps), "--jax-run", bits,
                            "--out", out], check=True)
            runs[f"jax{bits}"] = np.load(out)
    ptr = crowd(args.n, torch.float64).destpointer.numpy()
    for a, b in (("port32", "port64"), ("jax32", "jax64"),
                 ("port64", "jax64"), ("port32", "jax32")):
        print(json.dumps({"runs": f"{a} vs {b}", "n": args.n,
                          "steps": args.steps,
                          **distances(runs[a], runs[b], ptr)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
