"""The readings that the limits of `correct` are set from (never run by
the benchmark's own runs):

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 --control-seeds 3

For each seed, in one process, one run of the cell as `run.py` makes it
(`harness.run_cell`), with a short window at the cell's own load. Its
sampled chunks are compared with the float64 reference as every run
compares them: the program's readings, which set the lower end of each
limit. For the first `--control-seeds` seeds the same chunks are also
answered by the reference itself, computed in bfloat16, the next
precision below the configuration's float32 (the control's readings,
which set the upper end), and in float32 (a witness of what float32
arithmetic alone does to the widest gaps). One JSON line per seed.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the dtypes in which the reference answers in the program's place
CONTROL = "bfloat16"
WITNESS = "float32"


def readings(name: str, seed: int, seconds: float, control: bool,
             device="cuda") -> dict:
    """One seed's readings: the program's and, with `control`, the
    control's and the float32 witness's."""
    from benchmark import harness

    result, _ = harness.run_cell(name, seed, seconds, False, device,
                                 readings=(WITNESS, CONTROL) if control
                                 else ())
    return {"workload": name, "seed": seed, "attempted": result["attempted"],
            "failed": result["failed"], "correct": result["correct"],
            "reference_s": result["reference_s"], **result["readings"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  k < args.control_seeds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
