#!/usr/bin/env python3
"""ms per step of `chip_smoke.py`'s 100k-rider paths in this checkout
against another checkout of the repo (e.g. the commit before a change),
in turns, on one CUDA GPU.

    python3 scripts/slice_ab.py --other DIR [--rounds 5] [--paths P,...]

The step loop is host-bound, so its wall time drifts with the host over
a call by more than most changes move it: two checkouts compare only
when they alternate. Each round runs both checkouts, each in a process
of its own started in its directory (so each imports its own
`chip_smoke` and package and builds its own kernels), the order swapped
from round to round. A process drives the seven paths `slice`,
`slice_unrolled`, `slice_db`, `slice_legacy`, `slice_twod`,
`slice_mixed` and `slice_invpendulum` through its
`chip_smoke.phase_slice` (launch counts, device traces and overflow
audits included; the best of its timed runs), and
`slice_balancingrider`, `slice_stochastic` and `slice_stochastic_exact`
where its `chip_smoke` has those paths (`--paths`: only those named, e.g.
`slice,slice_unrolled,slice_db,slice_legacy`). Prints one JSON line per process
and path, then per path both medians (one where only this checkout has
the path), the spread of each checkout's own rounds and the rounds this
checkout won, and the nvidia-smi line last.

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
import sys
import torch
import chip_smoke as CS
from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
from cyclistsocialforce_tpu_torch.scenarios import build_population
want = set(sys.argv[1:])
def run(path):
    return not want or path in want
state = build_population(CS.N_AGENTS, CS.DENSITY, CS.HIST_LEN, CS.BLOCK,
                         torch.float32, "cuda")
k1, k2, k3 = PF.KERNELS
if run("slice"):
    CS.phase_slice("slice", CS.make_engine(), state, k1)
if run("slice_unrolled"):
    CS.phase_slice("slice_unrolled",
                   CS.make_engine(backend="pallas_unrolled"), state, k2)
if run("slice_db"):
    CS.phase_slice("slice_db", CS.phase_db_config(state), state, k3)
if run("slice_legacy"):
    CS.phase_slice("slice_legacy", CS.phase_legacy_config(state)[0], state,
                   k1)
if run("slice_twod"):
    twod = CS.twod_crowd(CS.N_AGENTS, torch.float32, "cuda")
    CS.phase_slice("slice_twod", CS.make_twod_engine(), twod, k1)
    del twod
if run("slice_mixed"):
    mixed = CS.twod_crowd(CS.N_AGENTS, torch.float32, "cuda", pad=None)
    CS.phase_slice("slice_mixed", CS.audited_engine(
        lambda **kw: CS.make_mixed_engine(CS.N_AGENTS, **kw), "slice_mixed",
        mixed), mixed, k1)
    del mixed
if run("slice_invpendulum"):
    ip = CS.model_crowd("invpendulum", CS.ip_params(), CS.N_AGENTS,
                        torch.float32, "cuda")
    CS.phase_slice("slice_invpendulum",
                   CS.make_model_engine("invpendulum", CS.ip_params()), ip,
                   k1)
    del ip
if hasattr(CS, "br_params") and run("slice_balancingrider"):
    br = CS.model_crowd("balancingrider", CS.br_params(), CS.N_AGENTS,
                        torch.float32, "cuda", hist_len=CS.HIST_LEN)
    CS.phase_slice("slice_balancingrider", CS.make_model_engine(
        "balancingrider", CS.br_params()), br, k1)
    del br
if hasattr(CS, "stochastic_path"):
    for row in ("stochastic", "stochastic_exact"):
        if run("slice_" + row):
            eng, st = CS.stochastic_path(row)
            CS.phase_slice("slice_" + row, eng, st, k1)
            del eng, st
"""


def run_paths(directory, paths=()):
    """{path: ms per step} of one process started in `directory`, of the
    paths named in `paths` (all where it is empty)."""
    res = subprocess.run([sys.executable, "-c", CHILD, *paths],
                         cwd=directory, capture_output=True, text=True)
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
    ap.add_argument("--paths", default="",
                    help="comma-separated paths to run (default: all)")
    args = ap.parse_args()
    paths = [p for p in args.paths.split(",") if p]
    builds = {"this": ROOT, "other": args.other.resolve()}
    ms = {tag: {} for tag in builds}       # tag -> path -> [ms per round]
    for rnd in range(args.rounds):
        for tag in (("this", "other") if rnd % 2 == 0
                    else ("other", "this")):
            for path, t in run_paths(builds[tag], paths).items():
                ms[tag].setdefault(path, []).append(t)
                print(json.dumps({"round": rnd, "build": tag, "path": path,
                                  "ms_per_step": t}), flush=True)
    for path in ms["this"]:
        a = ms["this"][path]
        b = ms["other"].get(path) or ms["other"].get(
            path.removesuffix(" eager"))
        if b is None:
            print(json.dumps({"path": path, "median_this":
                              statistics.median(a),
                              "range_this": [min(a), max(a)],
                              "rounds": args.rounds}), flush=True)
            continue
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
