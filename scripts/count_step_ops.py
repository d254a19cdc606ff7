#!/usr/bin/env python3
"""How many PyTorch operations one step of each path of `chip_smoke.py`
dispatches, on the CPU.

    python3 scripts/count_step_ops.py [--n 512]

Counts: one eager step of the sorted-resident chunk (`Engine.run_chunk`,
one step, after a warm-up step) of `slice`, `slice_twod`,
`slice_invpendulum` (poly and exact propagator), planarpoint,
planarbicycle, `slice_balancingrider` (gains_poly) and the balancing
rider's other gain modes and the Hess model on the stable crowd,
`slice_stochastic` (bench.py's "stochastic" row: on a step where its
cadence resamples, on one where it does not, and with the cadence decided
on the device) and `slice_stochastic_exact`, and the main path with
`chip_smoke.py`'s road (graph_parity's road case), each on an n-rider
crowd, under a `TorchDispatchMode`
that counts every aten operation (views included: on the card a view
launches no kernel, so the count bounds the device kernels from above).
A count of operations, not a device figure. Prints one JSON line per
path.
"""

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from cyclistsocialforce_tpu_torch.engine import permute_state  # noqa: E402
from cyclistsocialforce_tpu_torch.scenarios import (  # noqa: E402
    build_population, stochastic_row)


class Counter(TorchDispatchMode):
    """Counts the aten operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ops_per_step(engine, state, t0=None):
    """Operations of one sorted-resident step; `t0` the global step as the
    host knows it (None: a clock-dependent step decides on the device)."""
    cache = engine.neighbor_cache(state)
    state = permute_state(state, cache[0])
    engine.run_chunk(state, cache, 1, True, t0=t0)
    with Counter() as counter:
        engine.run_chunk(state, cache, 1, True, t0=t0)
    return counter.n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args()
    f32 = torch.float32
    paths = {
        "slice": (C.make_engine(), build_population(
            args.n, C.DENSITY, C.HIST_LEN, C.BLOCK, f32, "cpu")),
        "slice_twod": (C.make_twod_engine(),
                       C.twod_crowd(args.n, f32, "cpu")),
    }
    models = {"slice_invpendulum": ("invpendulum", C.ip_params()),
              **C.graph_parity_models()}
    for name, (model, params) in models.items():
        paths[name] = (C.make_model_engine(model, params),
                       C.model_crowd(model, params, args.n, f32, "cpu"))
    params = C.br_params(device="cpu")
    paths["slice_balancingrider"] = (
        C.make_model_engine("balancingrider", params),
        C.model_crowd("balancingrider", params, args.n, f32, "cpu",
                      hist_len=C.HIST_LEN))
    for mode in ("exact", "gains_lut", "prop_poly", "hess"):
        paths[f"{C.br_model(mode)}_{mode}"] = (
            C.make_model_engine(C.br_model(mode),
                                C.br_params(mode, "cpu")),
            C.stable_crowd(mode, args.n, f32, "cpu"))
    clocks = {}
    for row in ("stochastic", "stochastic_exact"):
        engine, state = stochastic_row(row, args.n, device="cpu")
        name = f"slice_{row}"
        paths[name] = (engine, state)
        clocks[name] = 0
        if row == "stochastic":
            for t0, tag in ((1, "not_resampling"), (None, "device_clock")):
                paths[f"{name}_{tag}"] = (engine, state)
                clocks[f"{name}_{tag}"] = t0
    paths["road"] = (C.make_engine(road=C.road_elements(args.n, f32, "cpu")),
                     build_population(args.n, C.DENSITY, C.HIST_LEN, C.BLOCK,
                                      f32, "cpu"))
    for name, (engine, state) in paths.items():
        print(json.dumps({"path": name, "n": args.n,
                          "aten_ops_per_step": ops_per_step(
                              engine, state, clocks.get(name))}),
              flush=True)


if __name__ == "__main__":
    main()
