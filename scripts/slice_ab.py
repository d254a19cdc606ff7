#!/usr/bin/env python3
"""ms per step of `chip_smoke.py`'s four 100k-rider paths in this checkout
against another checkout of the repo (e.g. the commit before a change),
in turns, on one CUDA GPU.

    python3 scripts/slice_ab.py --other DIR [--rounds 5]

The step loop is host-bound, so its wall time drifts with the host over
a call by more than most changes move it: two checkouts compare only
when they alternate. Each round runs both checkouts, each in a process
of its own started in its directory (so each imports its own
`chip_smoke` and package and builds its own kernels), the order swapped
from round to round. A process drives the four paths through its
`chip_smoke.phase_slice` (launch counts and overflow audits included;
best of 3 x 240 steps each). Prints one JSON line per process and path,
then per path both medians, the spread of each checkout's own rounds and
the rounds this checkout won, and the nvidia-smi line last.

A path's figure is that of `simulate` as a user calls it: since the
20-step chunk became a CUDA graph, the graphed loop. Where a checkout's
`phase_slice` also times the eager loop (`graph=False`), that figure is
kept as a path of its own, "<path> eager", and compared with the other
checkout's eager figure, or with its only figure where it has no graph.
Eager against graphed on ONE checkout needs no second checkout:
`chip_smoke.py` times the two in turns in every `slice*` phase.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHILD = """
import torch
import chip_smoke as CS
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
from cyclistsocialforce_tpu_torch.scenarios import build_population
state = build_population(CS.N_AGENTS, CS.DENSITY, CS.HIST_LEN, CS.BLOCK,
                         torch.float32, "cuda")
db = CS.phase_db_config(state)
leg, _ = CS.phase_legacy_config(state)
k1, k2, k3 = PF.KERNELS
CS.phase_slice("slice", CS.make_engine(), state, k1)
CS.phase_slice("slice_unrolled", CS.make_engine(backend="pallas_unrolled"),
               state, k2)
CS.phase_slice("slice_db", db, state, k3)
CS.phase_slice("slice_legacy", leg, state, k1)
"""


def run_paths(directory):
    """{path: ms per step} of one process started in `directory`."""
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=directory,
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{directory}: the paths failed\n"
                           f"{res.stderr[-4000:]}")
    out = {}
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            if "ms_per_step" in d:
                out[d["phase"]] = d["ms_per_step"]
                if "eager" in d.get("best_ms_per_step", {}):
                    out[d["phase"] + " eager"] = d["best_ms_per_step"][
                        "eager"]
    return out


def main():
    import chip_smoke as CS

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    builds = {"this": ROOT, "other": args.other.resolve()}
    ms = {tag: {} for tag in builds}       # tag -> path -> [ms per round]
    for rnd in range(args.rounds):
        for tag in (("this", "other") if rnd % 2 == 0
                    else ("other", "this")):
            for path, t in run_paths(builds[tag]).items():
                ms[tag].setdefault(path, []).append(t)
                print(json.dumps({"round": rnd, "build": tag, "path": path,
                                  "ms_per_step": t}), flush=True)
    for path in ms["this"]:
        a = ms["this"][path]
        b = ms["other"].get(path) or ms["other"][path.removesuffix(" eager")]
        print(json.dumps({
            "path": path, "median_this": statistics.median(a),
            "median_other": statistics.median(b),
            "range_this": [min(a), max(a)], "range_other": [min(b), max(b)],
            "rounds_this_faster": sum(x < y for x, y in zip(a, b)),
            "rounds": args.rounds}), flush=True)
    print(CS.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
