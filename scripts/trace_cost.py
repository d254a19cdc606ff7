#!/usr/bin/env python3
"""What the step loop's recorder (`cyclistsocialforce_tpu_torch.tracing`)
costs when it is on without a profiler: `Scenario.step_chunk` walls of a
benchmark cell with `tracing.recording()` and without, in turns, on one
CUDA GPU.

    python3 scripts/trace_cost.py --workload bicycle2d-district-8k \
        [--seed 7] [--rounds 6] [--chunks 10]

Builds the cell as `benchmark/run.py` does (its configuration, the
seeded crowd, one warm-up chunk), then runs `--rounds` rounds of two
blocks of `--chunks` chunks each, one block recorded and one not, the
order swapped from round to round; each block starts from the seeded
crowd. Prints one JSON line: the median and quartiles of each side's
chunk walls (ms), the recorded side's median over the other's, the last
recorded block's report, and the card's name and power limit.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def block(scen, chunks: int, recorded: bool) -> list:
    """The walls (ms) of `chunks` chunks from the seeded crowd."""
    import torch

    from cyclistsocialforce_tpu_torch import tracing

    scen.reset()
    torch.cuda.synchronize()
    walls = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        if recorded:
            with tracing.recording():
                scen.step_chunk(record=False)
        else:
            scen.step_chunk(record=False)
        walls.append(1e3 * (time.perf_counter() - t0))
    return walls


def quartiles(xs) -> dict:
    q = statistics.quantiles(xs, n=4)
    return {"p25": q[0], "median": q[1], "p75": q[2], "n": len(xs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--chunks", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from cyclistsocialforce_tpu_torch import tracing
    from cyclistsocialforce_tpu_torch.scenario import Scenario

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    _, cfg, mix, _ = harness.cell_files(args.workload)
    inputs = harness.generate(mix, args.seed)
    engine, state = harness.build_program(cfg, inputs, "cuda")
    scen = Scenario(engine, state, t_s=float(cfg["params"]["t_s"]),
                    chunk=int(mix["chunk_steps"]))
    scen.step_chunk(record=False)
    walls, last = {False: [], True: []}, None
    for r in range(args.rounds):
        for recorded in ((False, True) if r % 2 == 0 else (True, False)):
            tracing.clear()
            walls[recorded] += block(scen, args.chunks, recorded)
            if recorded:
                last = tracing.report()
    off, on = quartiles(walls[False]), quartiles(walls[True])
    info = harness.device_info(1, "cuda")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "off_ms": off, "recorded_ms": on,
                      "recorded_over_off": on["median"] / off["median"],
                      "last_report": last,
                      "device": info["kind"],
                      "power_limit_w": info["power_limit_w"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
