#!/usr/bin/env python3
"""The two designs of the stochastic balancing rider's resampling cadence
in a CUDA graph, timed in turns on one card.

    python3 scripts/stochastic_cadence.py [--n 100000] [--steps 240]
        [--rounds 2]

`bench.py:main_row("stochastic")` (`scenarios.stochastic_row`: 100,000
riders, budget 4,096, cadence 4, K1's main form, a rebuild every 20
steps) run graphed two ways: "host", as `Engine.simulate` runs it (the
clock read once per call, one capture per phase of the cadence at a
chunk's start, the resampler only in the steps where it fires), and
"device" (the engine's `clock_hook` removed: the resampler computed every
step and selected on the device with `torch.where`). Both final states
must be bit-equal. Prints one JSON line per run, the nvidia-smi name and
power limit, and a summary with the median ms per step of each, their
ratio, and device kernels per step of each from one profiler window of
40 steps.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def device_kernels_per_step(engine, state, steps):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.simulate(state, steps, record=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.simulate(state, steps, record=False)
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA
               for e in prof.events()) / steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    from cyclistsocialforce_tpu_torch.engine import _STATE_FIELDS
    from cyclistsocialforce_tpu_torch.scenarios import stochastic_row

    if not torch.cuda.is_available():
        print("stochastic_cadence: no CUDA device", file=sys.stderr)
        return 1
    host, state = stochastic_row("stochastic", args.n)
    device = host.with_params(host.params)
    device.clock_hook = None
    engines = {"host": host, "device": device}
    finals = {k: e.simulate(state, args.steps, record=False)[0]
              for k, e in engines.items()}
    torch.cuda.synchronize()
    differ = [f for f in _STATE_FIELDS
              if not torch.equal(getattr(finals["host"], f),
                                 getattr(finals["device"], f))]
    runs = {k: [] for k in engines}
    for _ in range(args.rounds):
        for k in ("host", "device", "device", "host"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[k].simulate(state, args.steps, record=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            runs[k].append(1e3 * dt / args.steps)
            print(json.dumps({"run": k, "ms_per_step": runs[k][-1]}),
                  flush=True)
    kernels = {k: device_kernels_per_step(e, state, 40)
               for k, e in engines.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    med = {k: statistics.median(v) for k, v in runs.items()}
    print(smi)
    print(json.dumps({"n": args.n, "steps": args.steps,
                      "median_ms_per_step": med,
                      "device_over_host": med["device"] / med["host"],
                      "device_kernels_per_step": kernels,
                      "captures": {k: len(e._runners)
                                   for k, e in engines.items()},
                      "fields_differing": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
