"""Build the package's CUDA kernels with nvcc and load them with ctypes.

`library()` compiles every `csrc/*.cu` file into an object, one nvcc
process per source, all started together, and links the objects into
one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under `build/kernels/` at the repository root. The
library is named by a hash of the sources, the headers they include
(`csrc/*.cuh`) and the flags, so an unchanged tree never rebuilds and an
edited header always does. It runs at the first CUDA launch, never at
import. A missing nvcc or a failed compile raises.
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
# -fmad=false: no contraction of a*b + c into one fused multiply-add, so
# K2 and K3 round each operation as their plain PyTorch version does and
# agree with it pair by pair, also where the force field is discontinuous
# (the FOV cone edge, the sign(sin phi) jump) and one rounding step
# decides which side of it a pair falls on. K1 does not rely on the flag:
# it rounds that decision chain with __fadd_rn/__fsub_rn/__fmul_rn, which
# no flag contracts, and fuses explicitly (fmaf) where the field is smooth
# (csrc/pair_math.cuh)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

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
    lib.csf_pair_forces_twod.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                         i, i, f, *field, i, p]
    lib.csf_pair_forces_unrolled.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                             i, i, *field, i, p]
    lib.csf_pair_forces_db.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i,
                                       p]
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
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
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
