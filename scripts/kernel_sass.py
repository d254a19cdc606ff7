#!/usr/bin/env python3
"""Registers and SASS instructions per pair of the port's three pair
kernels (K1 `csrc/pair_forces.cu`, K2 `csrc/pair_forces_unrolled.cu`, K3
`csrc/pair_forces_db.cu`), from `-Xptxas -v` and `cuobjdump -sass`.

    python3 scripts/kernel_sass.py [--parent CSRC_DIR] [--fmad-false]
                                   [--out DIR]

Compiles the checkout's three sources and, with --parent, those in
another checkout's `csrc/` directory (e.g. the commit before a change)
with that checkout's own nvcc flags (its `ops/_build.py`), each with
`-Xptxas -v`, one nvcc per source, side by side. With --fmad-false the
checkout's sources are built a second time with `-fmad=false` appended,
to show what the flag would change (`hot_loop_sha` equal: nothing).
Prints one JSON line per build and kernel: registers and spill of the
main form's instantiation at receiver block 128 (K1, K2: uniform, FOV;
K3: FOV, per-source columns) and of the mixed form (K1: with the tile
screen), the range over all forms, that range per receiver block (64,
128, 256), and the innermost loop of the main form and of its
priority-to-the-right form: instructions and MUFU operations per pair
(the loop's MUFU.EX2 count is its pairs: one exponential per twod pair)
and a hash of the loop's instructions with the addresses left out. The
compiler output and the loops' SASS go to --out (default
`build/kernel_sass/`). Needs nvcc and cuobjdump, no GPU.
"""

import argparse
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# kernel: (source, {form: mangled-name pattern}). Template arguments: the
# receiver block (Li128E; a checkout from before it was a template
# argument has none), then K1 uniform, fov, priority_p2r, screen, mixed; K2
# uniform, fov, priority_p2r, mixed; K3 fov, priority_p2r, mixed
BLOCK_ARG = "(?:Li128E)?"
KERNELS = {
    "k1": ("pair_forces.cu", {
        "main": f"pair_forces_twod_kernelI{BLOCK_ARG}Lb1ELb1ELb0ELb0ELb0E",
        "p2r": f"pair_forces_twod_kernelI{BLOCK_ARG}Lb1ELb1ELb1ELb0ELb0E",
        "mixed": f"pair_forces_twod_kernelI{BLOCK_ARG}Lb0ELb1ELb0ELb1ELb1E"}),
    "k2": ("pair_forces_unrolled.cu", {
        "main": f"pair_forces_unrolled_kernelI{BLOCK_ARG}Lb1ELb1ELb0ELb0E",
        "p2r": f"pair_forces_unrolled_kernelI{BLOCK_ARG}Lb1ELb1ELb1ELb0E",
        "mixed": f"pair_forces_unrolled_kernelI{BLOCK_ARG}Lb0ELb1ELb0ELb1E"}),
    "k3": ("pair_forces_db.cu", {
        "main": f"pair_forces_db_kernelI{BLOCK_ARG}Lb1ELb0ELb0E",
        "p2r": f"pair_forces_db_kernelI{BLOCK_ARG}Lb1ELb1ELb0E",
        "mixed": f"pair_forces_db_kernelI{BLOCK_ARG}Lb1ELb0ELb1E"}),
}
BLOCKS = (64, 128, 256)


def nvcc_flags(csrc):
    """NVCC_FLAGS of the checkout that holds `csrc` (its ops/_build.py,
    which imports the standard library only)."""
    spec = importlib.util.spec_from_file_location(
        f"_build_{abs(hash(str(csrc)))}",
        Path(csrc).resolve().parent / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.NVCC_FLAGS)


def build(out, tag, kernel, csrc, flags):
    """Compile the kernel's source in `csrc` into <out>/lib<kernel>_<tag>.so;
    returns (path, ptxas output)."""
    from cyclistsocialforce_tpu_torch.ops import _build

    so = out / f"lib{kernel}_{tag}.so"
    cmd = [_build._nvcc(), *flags, "-Xptxas", "-v", "-shared", "-o", str(so),
           str(Path(csrc) / KERNELS[kernel][0])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out / f"ptxas_{kernel}_{tag}.txt").write_text(res.stdout + res.stderr)
    if res.returncode:
        raise RuntimeError(f"{kernel} {tag}: nvcc failed\n"
                           f"{res.stderr[-4000:]}")
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


def report(out, tag, kernel, so, ptxas):
    forms = KERNELS[kernel][1]
    regs = registers(ptxas)
    funcs, labels = sass_functions(so)
    line = {"build": tag, "kernel": kernel}
    for key in ("main", "p2r"):
        name = next(n for n in funcs if re.search(forms[key], n))
        loop = hot_loop(funcs[name], labels[name])
        (out / f"hot_loop_{kernel}_{key}_{tag}.sass").write_text(
            "\n".join(loop["body"]))
        # branch targets are addresses: left out of the hash
        text = "\n".join(re.sub(r"0x[0-9a-f]+|\.L_x_\d+", "@", i)
                         for i in loop["body"])
        line[f"hot_loop_{key}"] = {
            "instructions": loop["instructions"], "mufu": loop["mufu"],
            "pairs": loop["pairs"],
            "instructions_per_pair": loop["instructions"] / loop["pairs"],
            "mufu_per_pair": loop["mufu"] / loop["pairs"],
            "hot_loop_sha": hashlib.sha256(text.encode()).hexdigest()[:12]}
    for key in ("main", "mixed"):
        line[f"registers_{key}"], line[f"spill_{key}"] = next(
            v for n, v in regs.items() if re.search(forms[key], n))
    line["registers_all"] = [min(r for r, _ in regs.values()),
                             max(r for r, _ in regs.values())]
    line["spill_all"] = max(s for _, s in regs.values())
    for block in BLOCKS:
        per = [v for n, v in regs.items() if f"ILi{block}E" in n]
        if per:
            line[f"registers_block{block}"] = [min(r for r, _ in per),
                                               max(r for r, _ in per)]
            line[f"spill_block{block}"] = max(s for _, s in per)
    return line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="csrc directory of another checkout")
    ap.add_argument("--fmad-false", action="store_true",
                    help="also build the checkout with -fmad=false appended")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "kernel_sass",
                    help="directory for compiler output and SASS")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "cyclistsocialforce_tpu_torch" / "csrc"
    specs = [("current", csrc, nvcc_flags(csrc))]
    if args.fmad_false:
        specs.append(("current_fmad_false", csrc,
                      nvcc_flags(csrc) + ["-fmad=false"]))
    if args.parent:
        specs.append(("parent", Path(args.parent), nvcc_flags(args.parent)))
    jobs = [(tag, kernel, src, flags) for tag, src, flags in specs
            for kernel in KERNELS]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda j: build(args.out, *j), jobs))
    for (tag, kernel, _, flags), (so, ptxas) in zip(jobs, built):
        print(json.dumps({**report(args.out, tag, kernel, so, ptxas),
                          "fmad_false": "-fmad=false" in flags}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
