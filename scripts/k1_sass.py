#!/usr/bin/env python3
"""Registers and SASS instructions per pair of K1 (the port's
`csrc/pair_forces.cu`), from `-Xptxas -v` and `cuobjdump -sass`.

    python3 scripts/k1_sass.py [--parent CSRC_DIR] [--out DIR]

Compiles the checkout's `pair_forces.cu` and, with --parent, the one in
another checkout's `csrc/` directory (e.g. the commit before a change),
with the package's nvcc flags (`ops/_build.py`) plus `-Xptxas -v`, one
nvcc per source, side by side. Prints one JSON line per build: registers
and spill of the main form's instantiation (uniform, FOV, unscreened) and
of the mixed form with the tile screen, the range over all forms, and the
innermost loop of the main form and of its priority-to-the-right form:
instructions and MUFU operations per pair (the loop's MUFU.EX2 count is
its pairs: one exponential per twod pair). The compiler output and the
loops' SASS go to --out (default `build/k1_sass/`). Needs nvcc and
cuobjdump, no GPU.
"""

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# template arguments: uniform, fov, priority_p2r, screen, mixed
MAIN = "pair_forces_twod_kernelILb1ELb1ELb0ELb0ELb0E"
MAIN_P2R = "pair_forces_twod_kernelILb1ELb1ELb1ELb0ELb0E"
MIXED_SCREEN = "pair_forces_twod_kernelILb0ELb1ELb0ELb1ELb1E"


def build(out, tag, csrc):
    """Compile `<csrc>/pair_forces.cu` into <out>/libk1_<tag>.so; returns
    (path, ptxas output)."""
    from cyclistsocialforce_tpu_torch.ops import _build

    so = out / f"libk1_{tag}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-o", str(so), str(Path(csrc) / "pair_forces.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out / f"ptxas_{tag}.txt").write_text(res.stdout + res.stderr)
    if res.returncode:
        raise RuntimeError(f"{tag}: nvcc failed\n{res.stderr[-4000:]}")
    return so, res.stderr


def registers(ptxas):
    """{kernel name: (registers, spill store bytes)} from `-Xptxas -v`."""
    regs, name, spill = {}, None, 0
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = (int(m.group(1)), spill)
    return regs


def sass_functions(so):
    """({function name: [(address, instruction)]}, {function name: {label:
    address}}) from cuobjdump."""
    from cyclistsocialforce_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs, labels, cur, pending = {}, {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur], labels[cur] = [], {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and cur:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if m and cur:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2).strip()))
    return funcs, labels


def hot_loop(instrs, labels):
    """The innermost loop (a backward branch with no other loop inside)
    with the most MUFU.EX2: {instructions, mufu, pairs, body}."""
    loops = []
    for addr, ins in instrs:
        m = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", ins)
        if not m:
            continue
        target = (labels.get(m.group(1)) if m.group(1)
                  else int(m.group(2), 16))
        if target is not None and target <= addr:
            loops.append((target, addr))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]
    best = None
    for lo, hi in inner:
        body = [ins for a, ins in instrs if lo <= a <= hi]
        ex2 = sum("MUFU.EX2" in i for i in body)
        if ex2 and (best is None or ex2 > best["pairs"]):
            best = {"instructions": len(body),
                    "mufu": sum("MUFU" in i for i in body), "pairs": ex2,
                    "body": body}
    return best


def report(out, tag, so, ptxas):
    regs = registers(ptxas)
    funcs, labels = sass_functions(so)
    line = {"build": tag}
    for key, pattern in (("main", MAIN), ("p2r", MAIN_P2R)):
        name = next(n for n in funcs if pattern in n)
        loop = hot_loop(funcs[name], labels[name])
        (out / f"hot_loop_{key}_{tag}.sass").write_text(
            "\n".join(loop["body"]))
        line[f"hot_loop_{key}"] = {
            "instructions": loop["instructions"], "mufu": loop["mufu"],
            "pairs": loop["pairs"],
            "instructions_per_pair": loop["instructions"] / loop["pairs"],
            "mufu_per_pair": loop["mufu"] / loop["pairs"]}
    for key, pattern in (("main", MAIN), ("mixed_screen", MIXED_SCREEN)):
        line[f"registers_{key}"], line[f"spill_{key}"] = next(
            v for n, v in regs.items() if pattern in n)
    line["registers_all"] = [min(r for r, _ in regs.values()),
                             max(r for r, _ in regs.values())]
    line["spill_all"] = max(s for _, s in regs.values())
    return line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="csrc directory of another checkout")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k1_sass",
                    help="directory for compiler output and SASS")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    specs = [("current", ROOT / "cyclistsocialforce_tpu_torch" / "csrc")]
    if args.parent:
        specs.append(("parent", Path(args.parent)))
    with ThreadPoolExecutor(len(specs)) as ex:
        built = list(ex.map(lambda s: build(args.out, *s), specs))
    for (tag, _), (so, ptxas) in zip(specs, built):
        print(json.dumps(report(args.out, tag, so, ptxas)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
