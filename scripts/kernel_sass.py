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
priority-to-the-right form (for K1 also of its FOV-off and unscreened
mixed forms, which walk every pair): instructions and MUFU operations per pair
(the loop's MUFU.EX2 count is its pairs: one exponential per twod pair)
and two hashes of the loop: of its instructions with the addresses left
out, and of its dataflow (`dataflow_sha`: equal where two loops compute
the same values and differ only in register allocation and the order of
independent instructions), and the instantiations that spill. The
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
        "mixed": f"pair_forces_twod_kernelI{BLOCK_ARG}Lb0ELb1ELb0ELb1ELb1E",
        "fov_off": f"pair_forces_twod_kernelI{BLOCK_ARG}Lb1ELb0ELb0ELb0ELb0E",
        "mixed_open": (f"pair_forces_twod_kernelI{BLOCK_ARG}"
                       "Lb0ELb1ELb0ELb0ELb1E")}),
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
# operand roles for dataflow_sha: opcodes that write no register, those
# that write two predicates, and those whose first two sources commute
NO_DEST = {"BRA", "BAR", "EXIT", "RED", "ATOM", "ATOMS", "STS", "STG", "STL",
           "ST", "NOP", "WARPSYNC", "BSSY", "BSYNC", "DEPBAR"}
TWO_DEST = {"FSETP", "ISETP", "DSETP"}
COMMUTE = {"FADD", "FMUL", "FFMA", "FMNMX", "IMAD", "DADD", "DMUL", "DFMA"}
CONTROL = {"BRA", "BSSY", "BSYNC", "CALL", "JMP", "BRX", "RET"}
REG = re.compile(r"\bU?[RP]\d+\b")


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
    """The innermost loop that evaluates the field (a backward branch over
    MUFU.EX2 with no other such loop inside; K1's cone loop holds a loop
    without one, its dealing of voters) with the most MUFU.EX2:
    {instructions, mufu, pairs, body}."""
    loops = []
    for addr, ins in instrs:
        m = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", ins)
        if not m:
            continue
        target = (labels.get(m.group(1)) if m.group(1)
                  else int(m.group(2), 16))
        if target is not None and target <= addr:
            loops.append((target, addr))
    loops = [lp for lp in loops
             if any("MUFU.EX2" in ins for a, ins in instrs
                    if lp[0] <= a <= lp[1])]
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


def dataflow_sha(body):
    """A hash of what a loop body computes, blind to register allocation
    and to the order of independent instructions: the multiset of the
    values it writes, each as the expression that computes it from the
    values it reads (commuting sources sorted), and of its stores. A
    register read before the loop writes it holds what the previous trip
    last wrote there, and is named by that; one the loop never writes is
    an anonymous input (so two loops that differ only in which of those
    they read where hash alike). Branch targets are left out."""
    carried = {}
    for _ in range(2):
        env, values = {}, []

        def read(reg):
            return env.get(reg) or carried.get(reg, "in")

        def group(reg, width):
            if width == 1 or not reg.startswith("R"):
                return [reg]
            return [f"R{int(reg[1:]) + k}" for k in range(width)]

        for ins in body:
            ins = ins.replace(".reuse", "")
            pred = None
            m = re.match(r"@(!?)(U?P\d+|PT)\s+(.*)", ins)
            if m:
                pred, ins = m.group(1) + read(m.group(2)), m.group(3)
            op, _, rest = ins.partition(" ")
            ops = [o.strip() for o in rest.split(",")] if rest else []
            base = op.split(".")[0]
            n_dest = (0 if base in NO_DEST else
                      2 if base in TWO_DEST else min(1, len(ops)))
            if base in CONTROL:
                ops = []
            # a 64- or 128-bit register operand names the first of 2 or 4
            width = 4 if ".128" in op else 2 if re.search(
                r"\.64|\.WIDE", op) else 1
            dests = ops[:n_dest]
            if width > 1 and len(dests) == 1 and REG.fullmatch(dests[0]):
                r0 = int(dests[0].lstrip("UR"))
                dests = [f"R{r0 + k}" for k in range(width)]
            # (an address in brackets is one register)
            srcs = [REG.sub(lambda r, w=1 if o.startswith("[") else width:
                            "{" + ",".join(read(g) for g in
                                           group(r.group(), w)) + "}", o)
                    for o in ops[n_dest:]]
            if base in COMMUTE:
                srcs = sorted(srcs[:2]) + srcs[2:]
            if not dests:
                values.append(repr(("store", op, pred, srcs)))
            for i, d in enumerate(dests):
                if not REG.fullmatch(d):
                    continue
                old = read(d) if pred else None
                env[d] = hashlib.sha256(repr(
                    (op, i, pred, srcs, old)).encode()).hexdigest()[:16]
                values.append(env[d])
        carried = {r: "carried " + v for r, v in env.items()}
    return hashlib.sha256("\n".join(sorted(values)).encode()).hexdigest()[:12]


def instantiation(name):
    """`kernel<128,1,1,0,0,0>` for a mangled kernel name: the receiver
    block, then the bool template arguments."""
    base = re.search(r"(pair_forces_[a-z_]*kernel)I", name)
    args = re.findall(r"L[ib](\d+)E", name)
    return f"{base.group(1) if base else name}<{','.join(args)}>"


def report(out, tag, kernel, so, ptxas):
    forms = KERNELS[kernel][1]
    regs = registers(ptxas)
    funcs, labels = sass_functions(so)
    line = {"build": tag, "kernel": kernel}
    # K1's forms without the FOV cone and its mixed form keep the loop
    # that walks every pair: their loops too, to hold against a parent's
    for key in ("main", "p2r", "fov_off", "mixed_open"):
        if key not in forms:
            continue
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
            "hot_loop_sha": hashlib.sha256(text.encode()).hexdigest()[:12],
            "dataflow_sha": dataflow_sha(loop["body"])}
    for key in ("main", "mixed"):
        line[f"registers_{key}"], line[f"spill_{key}"] = next(
            v for n, v in regs.items() if re.search(forms[key], n))
    line["registers_all"] = [min(r for r, _ in regs.values()),
                             max(r for r, _ in regs.values())]
    line["spill_all"] = max(s for _, s in regs.values())
    line["spills"] = sorted(instantiation(n) for n, (_, s) in regs.items()
                            if s)
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
