"""Build the package's CUDA kernels with nvcc and load them with ctypes.

`library()` compiles every `csrc/*.cu` file into an object, one nvcc
process per source, all started together, and links the objects into
one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under `build/kernels/` at the repository root. The
library is named by a hash of the sources, the headers they include
(`csrc/*.cuh`) and the flags, so an unchanged tree never rebuilds and an
edited header always does. It runs at the first CUDA launch, never at
import. A missing nvcc or a failed compile raises.

The three pair kernels (K1 `pair_forces.cu`, K2 `pair_forces_unrolled.cu`,
K3 `pair_forces_db.cu`) share one per-pair math (`pair_math.cuh`) and one
CTA shape (`pair_groups.cuh`), compiled for receiver blocks of 64, 128
and 256: a block of 128 is 8 groups of 64 threads (64: 8 groups of 32,
256: 4 groups of 128), 2 receivers per thread, whose partial sums are
added in a fixed order. K1 hands whole table slots to the groups (in
its FOV forms each warp then takes one receiver at a time against the
slot's rows on its lanes, and evaluates the field only for the runs of
rows whose vote finds a pair that needs it); K2
stages a row's tiles in shared memory in rounds of 96 KB (any kb) and
splits a round's rows evenly over the groups; K3 streams block-row tiles
through a 4-slot ring, every group on its strip of each tile, the tile
screen voted across the groups. `agent_step.cu` holds the per-agent
kernels around them (`ops/agent_step.py`), built without contraction
(`FILE_FLAGS`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# No flag constrains how the compiler rounds: the kernels round the
# operations that decide a pair at a discontinuity of the field (the FOV
# cone edge, the sign(sin phi) jump) with __fadd_rn/__fsub_rn/__fmul_rn,
# which nothing contracts, in their plain PyTorch version's order, and fuse
# explicitly (fmaf) where the field is smooth (csrc/pair_math.cuh)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
# flags of one source on top of NVCC_FLAGS: the per-agent kernels round
# every operation as PyTorch's CUDA kernels do, one at a time
# (csrc/agent_step.cu), so nothing there may be contracted into an FMA
FILE_FLAGS = {"agent_step.cu": ["-fmad=false"]}

_lib = None
build_seconds = None   # wall time of this process's compile (None: cached)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of cyclistsocialforce_tpu_torch need the CUDA toolkit")


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    field = [f] * 7                     # e_0, e_1, sigma_0..3, cos(hfov/2)
    # nbr, count, src, recv, out; n_blocks, kb, block; ...; device, stream
    head = [p] * 5 + [i] * 3
    # ..., the field-pair counter (or None), device, stream
    lib.csf_pair_forces_twod.argtypes = [*head, i, i, i, i, i, i, i, f,
                                         *field, p, i, p]
    lib.csf_pair_forces_unrolled.argtypes = [*head, i, i, i, i, i, *field,
                                             i, p]
    lib.csf_pair_forces_db.argtypes = [*head, i, i, i, f, i, p]
    # (the per-agent kernels' instances, `csf_agent_*`, are declared where
    # ops/agent_step.py first launches them)
    for fn in (lib.csf_pair_forces_twod, lib.csf_pair_forces_unrolled,
               lib.csf_pair_forces_db):
        fn.restype = i
    lib.csf_error_string.argtypes = [i]
    lib.csf_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds):
    """Run the commands side by side; raise on the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc={proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def library():
    """The loaded kernel library, compiled first if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(FILE_FLAGS.items())).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libcsf_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        try:
            _run_all([[nvcc, *NVCC_FLAGS, *FILE_FLAGS.get(src.name, ()),
                       "-c", "-o", str(obj), str(src)]
                      for src, obj in zip(sources, objs)])
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, out)
    _lib = _declare(ctypes.CDLL(str(out)))
    return _lib


def error_string(lib, rc: int) -> str:
    return f"{rc}: {lib.csf_error_string(rc).decode()}"
