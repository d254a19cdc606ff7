#!/usr/bin/env python3
"""Hold the checkout's pair kernels at receiver block 128 to another
checkout's, bit for bit, on one CUDA GPU.

    python3 scripts/block_parity.py --other <other checkout> [--blocks]

Builds the inputs of `chip_smoke.py`'s kernel forms at the main path's
shape (100,000 riders, 782 blocks of 128): K1 in its main form, with the
tile and the strip screen, per-rider columns, priority to the right and
the mixed form with the tile screen (legacy crowd and two-family pack);
K2 `uniform`, columns and mixed; K3 with per-rider columns, priority to
the right and mixed. Each checkout runs every form through its own
wrappers and kernels (the other one in a process of its own, its package
first on the path, its kernels built into its own `build/kernels/`).
Prints one JSON line per form (`bit_equal`, max |diff|) and exits
non-zero if any differs. With --blocks it then runs `chip_smoke.py`'s
checks of blocks 64 and 256 against the plain version. The nvidia-smi
line comes last.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "block_parity"


def forms(state):
    """{name: (wrapper name, (nbr, valid, src, recv), kwargs)} at block
    128, as chip_smoke.py's kernel_forms builds them."""
    import torch

    import chip_smoke as CS

    engine = CS.make_engine()
    db = CS.phase_db_config(state)
    leg, leg_db = CS.phase_legacy_config(state)
    cols = CS.make_engine(db.params)
    main_t, col_t, db_t = (CS.sorted_inputs(e, state)
                           for e in (engine, cols, db))
    leg_t, leg_db_t = CS.sorted_inputs(leg, state), CS.sorted_inputs(leg_db,
                                                                     state)
    two_t = CS.two_family(leg, state)
    u = engine.uniform_pair
    bs64 = dict(block=CS.BLOCK, block_src=CS.BLOCK_SRC)
    screen = dict(screen=True, cutoff=CS.CUTOFF)
    leg_screen = dict(screen=True, cutoff=CS.LEG_CUTOFF)
    k1, k2, k3 = ("pair_forces_neighbors", "pair_forces_neighbors_unrolled",
                  "pair_forces_neighbors_db")
    out = {
        "k1_main": (k1, main_t, {**bs64, "uniform": u}),
        "k1_screen": (k1, main_t, {**bs64, "uniform": u, **screen}),
        "k1_screen_sub32": (k1, main_t, {**bs64, "uniform": u, **screen,
                                         "sub": 32}),
        "k1_columns": (k1, col_t, bs64),
        "k1_p2r": (k1, main_t, {**bs64, "uniform": u,
                                "priority_p2r": True}),
        "k1_mixed_screen": (k1, leg_t, {**bs64, "mixed": True,
                                        **leg_screen}),
        "k1_two_family_screen": (k1, two_t, {**bs64, "mixed": True,
                                             **leg_screen}),
        "k2_uniform": (k2, main_t, {**bs64, "uniform": u}),
        "k2_columns": (k2, col_t, bs64),
        "k2_mixed": (k2, leg_t, {**bs64, "mixed": True}),
        "k3": (k3, db_t, {"block": CS.BLOCK, "cutoff": CS.CUTOFF}),
        "k3_p2r": (k3, db_t, {"block": CS.BLOCK, "cutoff": CS.CUTOFF,
                              "priority_p2r": True}),
        "k3_mixed": (k3, leg_db_t, {"block": CS.BLOCK,
                                    "cutoff": CS.LEG_CUTOFF, "mixed": True}),
    }
    torch.cuda.synchronize()
    return out


def run_forms(checkout, inputs, outputs):
    """Every form of `inputs` through `checkout`'s wrappers; the results
    saved to `outputs`."""
    sys.path.insert(0, str(Path(checkout).resolve()))
    import torch

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    todo = torch.load(inputs, weights_only=False)
    done = {name: getattr(PF, fn)(*(t.cuda() for t in tensors), **kw).cpu()
            for name, (fn, tensors, kw) in todo.items()}
    torch.cuda.synchronize()
    torch.save(done, outputs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the checkout to compare with")
    ap.add_argument("--blocks", action="store_true",
                    help="also check blocks 64 and 256 against the plain "
                         "version (chip_smoke.py's phase_block_forms)")
    ap.add_argument("--run", nargs=3, metavar=("CHECKOUT", "IN", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_forms(*args.run)
        return 0

    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as CS
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    if not torch.cuda.is_available():
        print("block_parity: no CUDA device available", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    state = build_population(CS.N_AGENTS, CS.DENSITY, CS.HIST_LEN, CS.BLOCK,
                             torch.float32, "cuda")
    todo = forms(state)
    inputs = OUT / "inputs.pt"
    torch.save({name: (fn, tuple(t.cpu() for t in tensors), kw)
                for name, (fn, tensors, kw) in todo.items()}, inputs)
    results = {}
    for tag, checkout in (("this", ROOT), ("other", Path(args.other))):
        out = OUT / f"out_{tag}.pt"
        subprocess.run([sys.executable, __file__, "--run", str(checkout),
                        str(inputs), str(out)], check=True)
        results[tag] = torch.load(out, weights_only=False)
    failed = []
    for name in todo:
        a, b = results["this"][name], results["other"][name]
        equal = torch.equal(a, b)
        print(json.dumps({"form": name, "block": CS.BLOCK,
                          "bit_equal": equal,
                          "max_abs_diff": float((a - b).abs().max()),
                          "max_abs_force": float(b.abs().max())}),
              flush=True)
        if not equal:
            failed.append(name)
    if args.blocks:
        CS.phase_block_forms(state)
    print(CS.nvidia_smi_line(), flush=True)
    if failed:
        print(f"block_parity: differs from {args.other} in {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
