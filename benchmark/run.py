"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output (one JSON object), the compared numbers with
their limits as the last lines of standard error.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics from a torch.profiler trace of one episode. Needs as many CUDA
devices as the cell asks for; exits non-zero without them, and when a
module of JAX or of the JAX package is loaded at the end.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of a build or a compile stays inside the checkout (the
# port's kernel library goes to build/kernels/ by itself)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
# one process with few threads: no idle CPU thread pool competes with the
# host's launch path, which leads on the small crowds
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.cell_files(args.workload, spec)[0]
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda",
                                     t_process=T_PROCESS)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"modules of JAX or the JAX package are loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    if "trace_sizes" in result:
        print(f"roofline peaks {result['trace_sizes']['peaks']} at "
              f"{result['device']['power_limit_w']} W", file=sys.stderr)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
