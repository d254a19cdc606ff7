#!/usr/bin/env python3
"""Time build variants of K2 (`csrc/pair_forces_unrolled.cu`) and K3
(`csrc/pair_forces_db.cu`) against the checkout's own build, in one call
on one CUDA GPU, at `chip_smoke.py`'s shapes.

    python3 scripts/kernel_variants.py k2:kStageBytes=200*1024 \\
        k3:kDepth=2 k3:kDepth=8

A variant is a copy of `csrc/` in which `constexpr int NAME = ...;` of the
named kernel's source (k1, k2 or k3) is given another value; nothing in
the package selects a variant, the sources keep the values they ship
with. Every variant and the unchanged sources ("current") are compiled
with the package's nvcc flags under `build/variants/`, all at once. Each
is held to the plain version in the forms timed (K2 `uniform` on the main
table and `mixed` on the legacy crowd; K3 on the per-rider-parameter
crowd and `mixed` on the legacy crowd; K1 in the same four forms as the
yardstick), then the builds are timed in turns, ROUNDS times over, each
time the median of 50 CUDA-event-timed calls. Prints one JSON line per
build and form with every round's time, and the nvidia-smi line last.
"""

import ctypes
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

ROUNDS = 3
SOURCES = {"k1": "pair_forces.cu", "k2": "pair_forces_unrolled.cu",
           "k3": "pair_forces_db.cu"}


def make_variant(tag, spec):
    """Copy csrc to build/variants/<tag>/ with `spec` ("k2:NAME=VALUE,...")
    applied; returns (directory, kernel the variant changes or None)."""
    from cyclistsocialforce_tpu_torch.ops import _build

    dst = ROOT / "build" / "variants" / tag
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    if spec is None:
        return dst, None
    kernel, changes = spec.split(":", 1)
    path = dst / SOURCES[kernel]
    text = path.read_text()
    for change in changes.split(","):
        name, value = change.split("=", 1)
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{spec}: {name} found {n} times in "
                             f"{SOURCES[kernel]}")
    path.write_text(text)
    return dst, kernel


def compile_all(dirs):
    """One nvcc per variant directory (all three sources into one
    library), all started together; returns the libraries' paths."""
    from cyclistsocialforce_tpu_torch.ops import _build

    libs = [d / "libcsf_kernels.so" for d in dirs]
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(lib), *map(str, sorted(d.glob("*.cu")))]
                     for d, lib in zip(dirs, libs)])
    return libs


def main():
    import torch

    from cyclistsocialforce_tpu_torch.ops import _build
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 1
    specs = [None, *sys.argv[1:]]
    tags = ["current", *(re.sub(r"[^A-Za-z0-9]+", "_", s)
                         for s in sys.argv[1:])]
    made = [make_variant(t, s) for t, s in zip(tags, specs)]
    libs = compile_all([d for d, _ in made])

    state = build_population(CS.N_AGENTS, CS.DENSITY, CS.HIST_LEN, CS.BLOCK,
                             torch.float32, "cuda")
    engine = CS.make_engine()
    db_engine = CS.phase_db_config(state)
    leg, leg_db = CS.phase_legacy_config(state)
    main_t, db_t, leg_t, leg_db_t = (
        CS.sorted_inputs(e, state) for e in (engine, db_engine, leg, leg_db))
    bs64 = dict(block=CS.BLOCK, block_src=CS.BLOCK_SRC)
    bs128 = dict(block=CS.BLOCK, block_src=CS.DB_BLOCK)
    main_kw = {**bs64, "uniform": engine.uniform_pair}
    mixed_kw = {**bs64, "mixed": True}
    db_plain = {**bs128, "screen": True, "cutoff": CS.CUTOFF}
    leg_db_plain = {**bs128, "screen": True, "cutoff": CS.LEG_CUTOFF,
                    "mixed": True}
    k1, k2, k3 = PF.KERNELS
    # kernel -> {form: (wrapper, tensors, kernel kwargs, plain kwargs)}
    forms = {
        "k1": {"k1_main": (k1, main_t, main_kw, main_kw),
               "k1_mixed": (k1, leg_t, mixed_kw, mixed_kw),
               "k1_screen_bs128_columns": (k1, db_t, db_plain, db_plain),
               "k1_mixed_screen_bs128": (k1, leg_db_t, leg_db_plain,
                                         leg_db_plain)},
        "k2": {"k2_uniform": (k2, main_t, main_kw, main_kw),
               "k2_mixed": (k2, leg_t, mixed_kw, mixed_kw)},
        "k3": {"k3": (k3, db_t, {"block": CS.BLOCK, "cutoff": CS.CUTOFF},
                      db_plain),
               "k3_mixed": (k3, leg_db_t,
                            {"block": CS.BLOCK, "cutoff": CS.LEG_CUTOFF,
                             "mixed": True}, leg_db_plain)},
    }
    plain = {name: PF.pair_forces_neighbors_ref(*t, **pkw)
             for fs in forms.values() for name, (_, t, _, pkw) in fs.items()}

    runs = []          # (tag, form, call) of every build's timed forms
    for tag, (_, kernel), lib in zip(tags, made, libs):
        loaded = _build._declare(ctypes.CDLL(str(lib)))
        for kern in ([kernel] if kernel else list(forms)):
            for name, (fn, t, kw, _) in forms[kern].items():
                def call(fn=fn, t=t, kw=kw, loaded=loaded):
                    _build._lib = loaded
                    return fn(*t, **kw)
                err = (call() - plain[name]).abs()
                tol = CS.KERNEL_ATOL + CS.KERNEL_RTOL * plain[name].abs()
                if int((err > tol).sum()):
                    raise AssertionError(f"{tag} {name}: disagrees with the "
                                         f"plain version (max {err.max()})")
                runs.append((tag, name, call, float(err.max())))
    times = {(tag, name): [] for tag, name, _, _ in runs}
    for _ in range(ROUNDS):
        for tag, name, call, _ in runs:
            times[tag, name].append(CS.cuda_ms(call, reps=50))
    for tag, name, _, err in runs:
        ms = times[tag, name]
        print(json.dumps({"build": tag, "form": name, "ms": ms,
                          "median_ms": sorted(ms)[len(ms) // 2],
                          "max_abs_err": err}), flush=True)
    print(CS.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
