#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the
script exits non-zero):

  1. device    the card's name, and its name and power limit as nvidia-smi
               reports them (every time printed below was taken on it);
  2. build     compile the CUDA kernels from the checkout's sources;
  3. kernel    the pair kernel against its plain PyTorch version on the
               card, at the main path's shape (100,000 riders padded to
               782 x 128, block_src = 64, kb = 19), with CUDA-event times;
  4. audit     no receiver block overflows the neighbor table at t = 0;
  5. slice     240 steps of Engine.simulate on the card: one pair-kernel
               launch per step, a finite state, no overflow at t = end,
               and the best-of-3 wall time per step;
  6. parity    an 8,192-rider crowd run 45 steps (two table-rebuild
               chunks and the per-step tail) on the card in float32 and on
               the CPU in float64 through the plain version, same initial
               state, compared on the final state.

Then a JSON line with the kernels' launch counts, errors and times, the
nvidia-smi line, and last `{"ok": true, "device": {...}}`. Without a CUDA
device the script exits non-zero before printing any result.
"""

import json
import math
import subprocess
import sys
import time

N_AGENTS, DENSITY, HIST_LEN = 100_000, 0.02, 8
BLOCK, BLOCK_SRC, KB, CUTOFF, REBUILD = 128, 64, 19, 50.0, 20
N_STEPS = 240
# the JAX package's float32 bar for its own pair kernel against its
# float64 oracle (tests/test_neighbors.py): |kernel - plain| <= A + R|plain|
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 2e-4
# card float32 vs CPU float64 after PARITY_STEPS steps, per agent. The
# bulk differs by float32 rounding of ~300 m coordinates (ulp 3e-5 m); a
# rare agent whose float32 and float64 runs cross a discontinuity of the
# field (the hard FOV cone edge, the sign(sin phi) jump straight ahead of
# a source) at different steps drifts further (a CPU float32-vs-float64
# rehearsal of this crowd: median 2.9e-5 m, 99.9th percentile 2.4e-4 m,
# one agent of 8192 at 1.3e-3 m). So: at least PARITY_QUANTILE of the
# agents within PARITY_TOL of each quantity, and every agent within
# PARITY_CAP.
PARITY_N, PARITY_STEPS = 8192, 45
PARITY_QUANTILE = 0.999
PARITY_TOL = {"pos": 1e-3, "psi": 1e-3, "v": 1e-3, "delta": 1e-3}
PARITY_CAP = {"pos": 1e-2, "psi": 5e-2, "v": 5e-2, "delta": 5e-2}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def neighbor_config():
    from cyclistsocialforce_tpu_torch import NeighborConfig

    return NeighborConfig(cutoff=CUTOFF, block=BLOCK, block_src=BLOCK_SRC,
                          kb=KB, rebuild_every=REBUILD)


def make_engine():
    from cyclistsocialforce_tpu_torch import Engine
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    return Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                         rep_force="twod", neighbors=neighbor_config())


def audit_overflow(engine, state, tag):
    """Assert that no receiver block has more in-range source blocks than
    the table holds (overflow would silently drop the farthest blocks'
    forces); returns the largest in-range count."""
    cache = engine.neighbor_cache(state)
    counts = cache[2].sum(dim=1)
    n_over = int(cache[3].sum())
    emit("audit", at=tag, max_in_range_blocks=int(counts.max()), kb=KB,
         overflow_blocks=n_over)
    if n_over:
        raise AssertionError(f"neighbor table overflow at {tag}: "
                             f"{n_over} receiver blocks exceed kb={KB}")
    return int(counts.max())


def cuda_ms(fn, reps):
    """Median milliseconds of `fn` over `reps` runs, each timed with CUDA
    events, after one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_kernel(engine, state):
    import torch

    from cyclistsocialforce_tpu_torch.engine import permute_state
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    cache = engine.neighbor_cache(state)
    sorted_state = permute_state(state, cache[0])
    src, recv = engine.pack_pair_fields(sorted_state)
    nbr, valid = cache[1], cache[2]
    kw = dict(block=BLOCK, block_src=BLOCK_SRC, uniform=engine.uniform_pair,
              fov=not engine.full_fov)
    out_k = PF.pair_forces_neighbors(nbr, valid, src, recv, **kw)
    out_r = PF.pair_forces_neighbors_ref(nbr, valid, src, recv, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all():
        raise AssertionError("pair kernel: non-finite forces")
    err = (out_k - out_r).abs()
    bound = KERNEL_ATOL + KERNEL_RTOL * out_r.abs()
    n_bad = int((err > bound).sum())
    max_abs_err = float(err.max())
    ms = cuda_ms(lambda: PF.pair_forces_neighbors(nbr, valid, src, recv,
                                                  **kw), reps=50)
    plain_ms = cuda_ms(lambda: PF.pair_forces_neighbors_ref(
        nbr, valid, src, recv, **kw), reps=5)
    candidates = int(valid.sum()) * BLOCK_SRC * BLOCK / state.n
    emit("kernel", name="pair_forces_neighbors", shape={
        "blocks": nbr.shape[0], "kb": nbr.shape[1], "block": BLOCK,
        "block_src": BLOCK_SRC, "n_src": src.shape[0]},
        candidate_pairs_per_agent=candidates, max_abs_err=max_abs_err,
        max_abs_force=float(out_r.abs().max()), n_over_tolerance=n_bad,
        atol=KERNEL_ATOL, rtol=KERNEL_RTOL, ms=ms, plain_ms=plain_ms)
    if n_bad:
        raise AssertionError(f"pair kernel disagrees with its plain version "
                             f"on {n_bad} values (max |diff| "
                             f"{max_abs_err:.3e})")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms}


def phase_slice(engine, state):
    import torch

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    torch.cuda.synchronize()
    PF.pair_forces_neighbors.launches = 0
    t0 = time.perf_counter()
    final, _ = engine.simulate(state, N_STEPS, record=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = PF.pair_forces_neighbors.launches
    finite = bool(torch.isfinite(final.s).all())
    emit("slice_run", steps=N_STEPS, kernel_launches=launches,
         finite=finite, first_run_s=first_s)
    if launches != N_STEPS:
        raise AssertionError(f"expected {N_STEPS} pair-kernel launches, "
                             f"counted {launches}")
    if not finite:
        raise AssertionError("non-finite state after the slice")
    audit_overflow(engine, final, "t=end")

    dts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.simulate(state, N_STEPS, record=False)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    dt = min(dts)
    emit("slice", n_agents=N_AGENTS, n_padded=state.n, steps=N_STEPS,
         ms_per_step=1e3 * dt / N_STEPS,
         agent_steps_per_s=N_AGENTS * N_STEPS / dt,
         spread_pct=100.0 * (max(dts) - dt) / dt, runs_s=dts)
    return launches


def phase_parity():
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    engine = make_engine()
    st_gpu = build_population(PARITY_N, DENSITY, HIST_LEN, BLOCK,
                              torch.float32, "cuda")
    st_cpu = build_population(PARITY_N, DENSITY, HIST_LEN, BLOCK,
                              torch.float64, "cpu")
    audit_overflow(engine, st_gpu, "parity t=0")
    fin_gpu, _ = engine.simulate(st_gpu, PARITY_STEPS, record=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin_cpu, _ = engine.simulate(st_cpu, PARITY_STEPS, record=False)
    cpu_s = time.perf_counter() - t0
    errs = parity_errors(fin_gpu, fin_cpu)
    emit("parity", n=PARITY_N, steps=PARITY_STEPS, rebuild_every=REBUILD,
         cpu_float64_s=cpu_s, **errs)
    if errs["failed"]:
        raise AssertionError(f"card vs CPU parity failed: {errs['failed']}")


def parity_errors(a, b):
    """Per-quantity error summary of final states `a` and `b`, and the
    list of checks that failed (see PARITY_TOL)."""
    import torch

    g, c = a.s.double().cpu(), b.s.double().cpu()

    def wrapped(d):
        return (torch.remainder(d + math.pi, 2 * math.pi) - math.pi).abs()

    per_agent = {"pos": torch.hypot(g[:, 0] - c[:, 0], g[:, 1] - c[:, 1]),
                 "psi": wrapped(g[:, 2] - c[:, 2]),
                 "v": (g[:, 3] - c[:, 3]).abs(),
                 "delta": wrapped(g[:, 4] - c[:, 4])}
    out = {"max": {}, "p99.9": {}, "n_over_tol": {}, "failed": []}
    n = g.shape[0]
    for k, e in per_agent.items():
        n_over = int((e > PARITY_TOL[k]).sum())
        out["max"][k] = float(e.max())
        out["p99.9"][k] = float(e.quantile(0.999))
        out["n_over_tol"][k] = n_over
        if n_over > (1.0 - PARITY_QUANTILE) * n or not e.max() <= \
                PARITY_CAP[k]:
            out["failed"].append(k)
    for f in ("znav", "destpointer"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            out["failed"].append(f)
    out.update(tol=PARITY_TOL, cap=PARITY_CAP, quantile=PARITY_QUANTILE)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from cyclistsocialforce_tpu_torch.ops import _build
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", name=name, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, library=lib._name)

    engine = make_engine()
    state = build_population(N_AGENTS, DENSITY, HIST_LEN, BLOCK,
                             torch.float32, "cuda")
    kernel = phase_kernel(engine, state)
    audit_overflow(engine, state, "t=0")
    launches = phase_slice(engine, state)
    phase_parity()

    print(json.dumps({"kernels": [{
        "name": "pair_forces_neighbors", "route": "cuda",
        "source": "cyclistsocialforce_tpu_torch/csrc/pair_forces.cu",
        "replaces": "cyclistsocialforce_tpu/ops/pallas_forces.py:75",
        "launches": launches, **kernel}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
