#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU.

    python3 chip_smoke.py

It drives four paths: the main path through K1 (`csrc/pair_forces.cu`,
twod field, unscreened), the same path through K2
(`csrc/pair_forces_unrolled.cu`, backend "pallas_unrolled"), a crowd with
per-rider field parameters through K3 (`csrc/pair_forces_db.cu`, backend
"pallas_db"), and bicycle2d's default legacy field through K1's
mixed-family form (tile screen, the NeighborConfig default). Phases, each
printing one JSON line (a failing phase raises and the script exits
non-zero):

  1. device    the card's name, and its name and power limit as nvidia-smi
               reports them (every time printed below was taken on it);
  2. build     compile the CUDA kernels from the checkout's sources;
  3. kernel    K1 in the main path's form against its plain PyTorch
               version on the card, at the main path's shape (100,000
               riders padded to 782 x 128, block_src = 64, kb = 19), with
               CUDA-event times;
  4. kernel_forms  every other form of K1, K2 and K3 against its plain
               version at the same shape and with CUDA-event times; then
               the mixed-family forms at the legacy path's shape (cutoff
               100 m, block_src 64, kb from the audit; K3 at block_src
               128), on the legacy crowd and on a two-family pack (every
               other rider a twod row with per-rider columns). Four
               in-call yardsticks, each timed in turns (a, b, b, a): K1's
               main form against K2's `uniform` form on the same table,
               K1 in K3's form (tile screen, columns, block_src 128)
               against K3 on the same table, K1's mixed form with the
               tile screen (slice_legacy's) against K3's mixed form on the
               legacy crowd, and K1's mixed form unscreened against K2's
               mixed form on the same table;
  5. audit     no receiver block overflows the neighbor table at t = 0;
  6. slice     240 steps of Engine.simulate on the card, as a user calls it:
               each 20-step chunk one replay of a CUDA graph. 240 K1
               launches counted (12 replays x the 20 launches the capture
               recorded) beside the 20 of the capture's warm-up chunk that
               K1's wrapper counted, a finite state, no overflow at t =
               end, the time of the first run and of the capture in it; a
               device trace of 40 more graphed steps, which must show 40
               runs of K1's kernel and none of K2's or K3's; then the eager loop (`graph=False`) and the graphed one
               timed in turns, three runs of each: ms per step of both,
               their spreads and the ratio;
  7. slice_unrolled  the same 240 steps through K2: 240 K2 launches and
               no K1 launch;
  8. slice_db  240 steps of 100,000 riders with per-rider f_0 and sigma_0
               (+-5%) through K3 at block = block_src = 128, kb from the
               overflow audit plus a margin: 240 K3 launches;
  9. slice_legacy  240 steps of the 100,000 riders with bicycle2d's
               default field, Engine.create(BicycleParams.create(),
               MODELS["bicycle2d"], neighbors=NeighborConfig(cutoff=100,
               block=128, block_src=64, kb=<audited max + 2>,
               rebuild_every=20)): 240 K1 launches, none of K2 or K3;
 10. parity    a 6,144-rider crowd run 45 steps (two table-rebuild
               chunks and the per-step tail) on the card in float32 and on
               the CPU in float64 through the plain version, same initial
               state, compared on the final state;
 11. parity_db the K3 path against the K1 path (tile screen, block_src =
               128) on the card, 45 steps of the slice_db crowd; and the
               K3 path on the card in float32 against the CPU float64
               plain version on a 2,048-rider crowd;
 12. parity_legacy  the slice_legacy configuration on a 4,096-rider crowd,
               45 steps on the card in float32 against the plain version
               on the CPU in float32 (the two tiers of `parity`) and in
               float64 (every rider within the cap; the 99.9% tier is
               reported beside the CPU float32 run's own distance from
               float64, which fails it alike: see PARITY_LEG_N);
 13. graph_parity  on each of the four paths 45 steps (two chunks and a
               5-step tail) with `graph=False` and with the graph from the
               same 100,000-rider state: every field of the final state
               bit-equal, again with `record_metrics=True`, and with
               `record=True` on a 4,096-rider crowd; one eager chunk with
               every host synchronisation an error;
 14. metrics   `simulate(state, 240, record=False, record_metrics=True)` on
               the main path: [240, 8], finite, 100,000 active and no
               overflow in every row, speeds within the model's limits;
 15. aliasing  two `simulate` calls on one engine from two states: the
               first call's state and records are unchanged by the second;
 16. profile   one torch.profiler window of 40 graphed steps of the main
               path: device kernels and host launches per step, device-busy
               ms per step, the card's idle share, the kernels that take
               most of the time.

Then the script's wall time, a JSON line with the kernels' launch counts
(each from its own path, with every count set to 0 just before it: the
replayed launches, and the warm-up's beside them),
errors, times, bounds (with the floor that sets each: FP32, MUFU or
bytes) and the four yardstick ratios (`vs_k1`: K1's time over the
kernel's, same work, same call), the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Without a CUDA device the script exits
non-zero before printing any result.
"""

import json
import math
import statistics
import subprocess
import sys
import time

N_AGENTS, DENSITY, HIST_LEN = 100_000, 0.02, 8
BLOCK, BLOCK_SRC, KB, CUTOFF, REBUILD = 128, 64, 19, 50.0, 20
N_STEPS = 240
# graph_parity: two chunks and a 5-step tail; the recorded run's crowd
GRAPH_PARITY_STEPS, GRAPH_PARITY_RECORD_N = 45, 4096
# the profiled window: two chunks
PROFILE_STEPS = 40
# the JAX package's float32 bar for its own pair kernel against its
# float64 oracle (tests/test_neighbors.py): |kernel - plain| <= A + R|plain|
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 2e-4
# card float32 vs CPU float64 after PARITY_STEPS steps, per agent. The
# bulk differs by float32 rounding of ~300 m coordinates (ulp 3e-5 m); a
# rare agent whose float32 and float64 runs cross a discontinuity of the
# field (the hard FOV cone edge, the sign(sin phi) jump straight ahead of
# a source) at different steps drifts further (a CPU float32-vs-float64
# rehearsal of an 8,192-rider crowd: median 2.9e-5 m, 99.9th percentile
# 2.4e-4 m, one agent at 1.3e-3 m). So: at least PARITY_QUANTILE of the
# agents within PARITY_TOL of each quantity, and every agent within
# PARITY_CAP. The crowd is 6,144 riders (8,192 before the legacy path's
# parity run was added; cut to keep the script near 200 s on the card).
# Its own CPU float32-vs-float64 rehearsal: max 4.5e-3 m, 2 riders above
# 1e-3 m/s, inside both tiers (a 4,096-rider draw put one rider past the
# cap, 1.1e-2 m, and is not used).
PARITY_N, PARITY_STEPS = 6144, 45
PARITY_QUANTILE = 0.999
PARITY_TOL = {"pos": 1e-3, "psi": 1e-3, "v": 1e-3, "delta": 1e-3}
PARITY_CAP = {"pos": 1e-2, "psi": 5e-2, "v": 5e-2, "delta": 5e-2}
# K3 path: source blocks of 128 (K3 needs block_src == block), per-rider
# f_0 and sigma_0 jittered by +-JITTER (numpy, seeded), kb = the audited
# maximum of in-range blocks plus KB_MARGIN (tests/test_neighbors.py)
DB_BLOCK, JITTER, JITTER_SEED, KB_MARGIN = 128, 0.05, 7, 2
# the K3 path's CPU float64 crowd: 2,048 riders (4,096 before the legacy
# path's parity run was added; halved to keep the script near 200 s on
# the card; the plain version in float32 against float64 on this crowd,
# CPU: max 1.06e-4 m, well inside both tiers)
PARITY_DB_N = 2048
# legacy path: bicycle2d's default field, whose slow forward decay wants a
# ~100 m cutoff (the JAX package's NeighborConfig docstring). Within 100 m
# many sources sit near a receiver's FOV cone edge, where a source's whole
# force (up to ~0.1 at 50 m ahead) switches on or off: float32 and float64
# runs of the same crowd cross those edges at different steps. On the
# CPU, the plain version in float32 against float64 on the parity_legacy
# crowd gives exactly the card's distances (max 2.96e-3 m, 5 riders of
# 4,096 above 1e-3 rad of steer): the 99.9% tier is beyond float32 here,
# so the card is held to the CPU float32 run under both tiers and to the
# float64 run under the cap.
LEG_CUTOFF, PARITY_LEG_N = 100.0, 4096
# the bound of a call: the largest of its operations over the H100's FP32
# peak and bytes over its memory rate (NVIDIA's data sheet, SXM part at
# 700 W), and its special-function (MUFU) operations over the MUFU rate:
# 16 results per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0: reciprocal square root,
# base-2 exponential) x 132 SMs x 1.98 GHz. FP32 operations per pair,
# counted from the plain version's function (ops/pair_forces.py
# tile_forces), operation by operation as it is written there: every
# FP32 add, subtract, multiply, negation, min/max and comparison counts
# one, the MUFU operations (rsqrt, sqrt, exp) none (per-receiver work
# excluded; the kernels' csrc/pair_math.cuh add_pairs fuses some of them
# into multiply-adds, which the bound does not credit). Base forms
# without the FOV cone and priority to the right; the cone adds 5,
# priority to the right 4, the mixed form's family test 1. MUFU operations per pair, the least the field needs: twod 5 (the
# rsqrts of rho2, m4 and |(u, v)|^2, one rsqrt for the exponent's
# sqrt(rho2 ec2) / sigma, the exponential), legacy 2 (rsqrt, exp).
PEAK_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
PEAK_SFU_PER_S = 132 * 16 * 1.98e9
OPS_TWOD, OPS_LEGACY, OPS_FOV, OPS_P2R, OPS_FAMILY = 67, 35, 5, 4, 1
OPS_SFU_TWOD, OPS_SFU_LEGACY = 5, 2
# calls timed in turns (a, b, b, a) for the in-call yardsticks
YARDSTICK_REPS = 50
SRC = "cyclistsocialforce_tpu_torch/csrc/"
TPU = "cyclistsocialforce_tpu/ops/pallas_forces.py:"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def neighbor_config(**kw):
    """The main path's NeighborConfig (K1, unscreened), with `kw` changed."""
    from cyclistsocialforce_tpu_torch import NeighborConfig

    cfg = dict(cutoff=CUTOFF, block=BLOCK, block_src=BLOCK_SRC, kb=KB,
               rebuild_every=REBUILD, screen=False)
    return NeighborConfig(**{**cfg, **kw})


def make_engine(params=None, **kw):
    from cyclistsocialforce_tpu_torch import Engine
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    return Engine.create(params or BicycleParams.create(),
                         MODELS["bicycle2d"], rep_force="twod",
                         neighbors=neighbor_config(**kw))


def make_legacy_engine(params=None, **kw):
    """bicycle2d with its default field (no rep_force: the model's
    "legacy") and the NeighborConfig defaults but for the legacy path's
    cutoff, blocks and rebuild interval, with `kw` changed."""
    from cyclistsocialforce_tpu_torch import Engine, NeighborConfig
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    cfg = dict(cutoff=LEG_CUTOFF, block=BLOCK, block_src=BLOCK_SRC,
               rebuild_every=REBUILD)
    return Engine.create(params or BicycleParams.create(),
                         MODELS["bicycle2d"],
                         neighbors=NeighborConfig(**{**cfg, **kw}))


def jittered_params(n, device, dtype):
    """Shared BicycleParams with per-rider f_0 and sigma_0 [n] on `device`
    (broadcast by `as_population`, scaled by a seeded numpy draw in
    1 +- JITTER): the field columns the K3 path reads. The other fields
    stay shared floats, so the state keeps its dtype."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.params import BicycleParams, as_population

    base = BicycleParams.create()
    pop = as_population(base, n, device=device)
    rng = np.random.default_rng(JITTER_SEED)

    def jitter():
        return torch.as_tensor(1 + JITTER * rng.uniform(-1, 1, n),
                               device=device)

    return base.replace(f_0=(pop.f_0 * jitter()).to(dtype),
                        sigma_0=(pop.sigma_0 * jitter()).to(dtype))


def audit_overflow(engine, state, tag):
    """Assert that no receiver block has more in-range source blocks than
    the table holds (overflow would silently drop the farthest blocks'
    forces); returns the largest in-range count."""
    cache = engine.neighbor_cache(state)
    counts = cache[2].sum(dim=1)
    n_over = int(cache[3].sum())
    kb = engine.neighbors.kb
    emit("audit", at=tag, max_in_range_blocks=int(counts.max()), kb=kb,
         block_src=engine.neighbors.block_src, overflow_blocks=n_over)
    if n_over:
        raise AssertionError(f"neighbor table overflow at {tag}: "
                             f"{n_over} receiver blocks exceed kb={kb}")
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


def sorted_inputs(engine, state):
    """(nbr, valid, src, recv): the engine's table and its cell-sorted
    packs, as the sorted-resident step hands them to the pair kernel."""
    from cyclistsocialforce_tpu_torch.engine import permute_state

    cache = engine.neighbor_cache(state)
    src, recv = engine.pack_pair_fields(permute_state(state, cache[0]))
    return cache[1], cache[2], src, recv


def work(tensors, plain_kw):
    """What one call of the form needs: the pairs it evaluates (the valid
    tiles' pairs, after the screen where one applies: those of the tiles or
    strips it admits), legacy rows' pairs apart in the mixed form, the
    operations and MUFU operations they take (OPS_*), and the bytes of
    every input read once and the output written once; with the bound
    these give. `bound_by` says whether operations (FP32 or MUFU, as
    `floor` names) or bytes set it."""
    import torch

    nbr, valid, src, recv = tensors
    block_src = plain_kw.get("block_src", BLOCK)
    strip = plain_kw.get("sub") or block_src
    rows, n_strips = src.shape[0] // block_src, block_src // strip
    idx = nbr.long()
    admit = valid[..., None].expand(*valid.shape, n_strips)   # [B, KB, ns]
    if plain_kw.get("screen"):
        xs = src[:, 0].reshape(rows, block_src)[idx]           # [B, KB, S]
        ys = src[:, 1].reshape(rows, block_src)[idx]
        xr = recv[0].reshape(nbr.shape[0], 1, 1, BLOCK)
        yr = recv[1].reshape(nbr.shape[0], 1, 1, BLOCK)
        dx, dy = xr - xs[..., None], yr - ys[..., None]
        rho2 = (dx * dx + dy * dy).reshape(*nbr.shape, n_strips, -1)
        cutoff = plain_kw["cutoff"]
        admit = admit & (rho2.amin(dim=-1) <= cutoff * cutoff)
    pieces = int(admit.sum())
    pairs = pieces * strip * BLOCK
    legacy_pairs = 0
    mixed = bool(plain_kw.get("mixed"))
    if mixed:
        fam = (src[:, 13] > 0.5).reshape(rows, block_src)[idx]
        per_strip = fam.reshape(*nbr.shape, n_strips, strip).sum(dim=-1)
        legacy_pairs = int((per_strip * admit).sum()) * BLOCK
    fov = plain_kw.get("fov", True)
    p2r = plain_kw.get("priority_p2r", False)
    extra = OPS_FOV * fov + OPS_P2R * p2r + OPS_FAMILY * mixed
    ops = ((pairs - legacy_pairs) * (OPS_TWOD + extra)
           + legacy_pairs * (OPS_LEGACY + extra))
    sfu_ops = ((pairs - legacy_pairs) * OPS_SFU_TWOD
               + legacy_pairs * OPS_SFU_LEGACY)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += 2 * recv.shape[1] * 4
    floors = {"fp32": 1e3 * ops / PEAK_FLOPS,
              "sfu": 1e3 * sfu_ops / PEAK_SFU_PER_S,
              "bytes": 1e3 * nbytes / PEAK_BYTES_PER_S}
    floor = max(floors, key=floors.get)
    out = {"candidate_pairs": int(valid.sum()) * block_src * BLOCK,
           "pairs": pairs, "legacy_pairs": legacy_pairs, "operations": ops,
           "sfu_operations": sfu_ops, "bytes": nbytes,
           "floors_ms": floors, "bound_ms": floors[floor],
           "bound_by": "bytes" if floor == "bytes" else "operations",
           "floor": floor}
    if plain_kw.get("screen"):
        out["screen_admits"] = pieces / float(valid.sum() * n_strips)
    return out


def check_form(phase, form, fn, tensors, kw, plain_kw):
    """Kernel `fn` against its plain version on `tensors` (forms of the
    plain version in `plain_kw`): assert |diff| <= KERNEL_ATOL +
    KERNEL_RTOL |plain| everywhere, time both with CUDA events, count the
    call's work and bound (`work`), emit one line; returns {max_abs_err,
    ms, plain_ms, bound_ms, bound_by, library_ms}."""
    import torch

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    nbr, valid, src, recv = tensors
    out_k = fn(*tensors, **kw)
    out_r = PF.pair_forces_neighbors_ref(*tensors, **plain_kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all():
        raise AssertionError(f"{form}: non-finite forces")
    err = (out_k - out_r).abs()
    n_bad = int((err > KERNEL_ATOL + KERNEL_RTOL * out_r.abs()).sum())
    max_abs_err = float(err.max())
    ms = cuda_ms(lambda: fn(*tensors, **kw), reps=50)
    plain_ms = cuda_ms(lambda: PF.pair_forces_neighbors_ref(*tensors,
                                                            **plain_kw),
                       reps=5)
    w = work(tensors, plain_kw)
    emit(phase, form=form, name=fn.__name__, shape={
        "blocks": nbr.shape[0], "kb": nbr.shape[1], "block": BLOCK,
        "block_src": plain_kw.get("block_src", BLOCK),
        "n_src": src.shape[0]},
        options={k: v for k, v in plain_kw.items()
                 if k not in ("block", "uniform")},
        uniform=plain_kw.get("uniform") is not None, **w,
        max_abs_err=max_abs_err, max_abs_force=float(out_r.abs().max()),
        n_over_tolerance=n_bad, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, ms=ms,
        plain_ms=plain_ms)
    if n_bad:
        raise AssertionError(f"{form}: {fn.__name__} disagrees with its "
                             f"plain version on {n_bad} values (max |diff| "
                             f"{max_abs_err:.3e})")
    # no single PyTorch call computes a block-sparse pair sum
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "floor": w["floor"], "library_ms": None}


def alternate(name_a, fn_a, name_b, fn_b):
    """In-call yardstick: time a and b in turns (a, b, b, a), each the
    median of YARDSTICK_REPS CUDA-event-timed calls, and emit a's mean
    over b's mean. Launch counts are not read here."""
    times = {name_a: [], name_b: []}
    for name, fn in ((name_a, fn_a), (name_b, fn_b), (name_b, fn_b),
                     (name_a, fn_a)):
        times[name].append(cuda_ms(fn, reps=YARDSTICK_REPS))
    ratio = sum(times[name_a]) / sum(times[name_b])
    emit("kernel_forms", yardstick=f"{name_a} / {name_b}", ms=times,
         ratio=ratio)
    return ratio


def phase_kernel(engine, state):
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    kw = dict(block=BLOCK, block_src=BLOCK_SRC, uniform=engine.uniform_pair,
              fov=not engine.full_fov)
    return check_form("kernel", "main", PF.pair_forces_neighbors,
                      sorted_inputs(engine, state), kw, kw)


def phase_kernel_forms(engine, db_engine, state):
    """Every other single-family form of the three kernels at the main
    path's shape: K1 and K2 on the main table (block_src 64, kb 19), K3
    and K1 in K3's form on the K3 path's table (block_src 128). Per-source
    column forms run on the K3 path's per-rider parameters."""
    import math

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    k1, k2, k3 = (PF.pair_forces_neighbors, PF.pair_forces_neighbors_unrolled,
                  PF.pair_forces_neighbors_db)
    full_fov = make_engine(BicycleParams.create(hfov=2 * math.pi))
    columns = make_engine(db_engine.params)
    main_t, fov_t, col_t = (sorted_inputs(e, state)
                            for e in (engine, full_fov, columns))
    db_t = sorted_inputs(db_engine, state)
    u = engine.uniform_pair
    bs64 = dict(block=BLOCK, block_src=BLOCK_SRC)
    bs128 = dict(block=BLOCK, block_src=DB_BLOCK)
    screen = dict(screen=True, cutoff=CUTOFF)
    # name: (kernel, packs, kernel kwargs, plain-version kwargs or None
    # for the same)
    forms = {
        "k1_screen": (k1, main_t, {**bs64, "uniform": u, **screen}, None),
        "k1_screen_sub32": (k1, main_t,
                            {**bs64, "uniform": u, **screen, "sub": 32},
                            None),
        "k1_fov_off": (k1, fov_t, {**bs64, "uniform": full_fov.uniform_pair,
                                   "fov": False}, None),
        "k1_columns": (k1, col_t, {**bs64}, None),
        "k1_p2r": (k1, main_t, {**bs64, "uniform": u, "priority_p2r": True},
                   None),
        "k2_uniform": (k2, main_t, {**bs64, "uniform": u}, None),
        "k2_columns": (k2, col_t, {**bs64}, None),
        "k3": (k3, db_t, {"block": BLOCK, "cutoff": CUTOFF},
               {**bs128, **screen}),
        "k3_p2r": (k3, db_t, {"block": BLOCK, "cutoff": CUTOFF,
                              "priority_p2r": True},
                   {**bs128, **screen, "priority_p2r": True}),
        # K3's computation through K1, for the time comparison
        "k1_screen_bs128_columns": (k1, db_t, {**bs128, **screen}, None),
    }
    out = {name: check_form("kernel_forms", name, fn, t, kw, plain or kw)
           for name, (fn, t, kw, plain) in forms.items()}
    main_kw = {**bs64, "uniform": u, "fov": not engine.full_fov}
    k1_db_kw, k3_kw = forms["k1_screen_bs128_columns"][2], forms["k3"][2]
    ratios = {
        "k2_uniform": alternate("k1 main", lambda: k1(*main_t, **main_kw),
                                "k2 uniform",
                                lambda: k2(*main_t, **main_kw)),
        "k3": alternate("k1 screen bs128 columns",
                        lambda: k1(*db_t, **k1_db_kw),
                        "k3", lambda: k3(*db_t, **k3_kw)),
    }
    return out, ratios


def two_family(engine, state):
    """(nbr, valid, src, recv) of a two-family pack: the legacy `engine`'s
    table and sorted packs with every other rider (odd uid) a twod row of
    per-rider columns (the K3 path's jittered f_0 and sigma_0, family
    0)."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import permute_state

    cache = engine.neighbor_cache(state)
    st = permute_state(state, cache[0])
    src_leg, recv = engine.pack_pair_fields(st)
    params = jittered_params(state.n, "cuda", torch.float32)
    src_twod, _ = make_engine(params).pack_pair_fields(st)
    odd = (st.uid % 2 == 1)[:, None]
    return cache[1], cache[2], torch.where(odd, src_twod, src_leg), recv


def phase_mixed_forms(leg, leg_db, state):
    """The mixed-family forms at the legacy path's shape: K1 unscreened,
    with the tile screen (the slice_legacy form), the strip screen
    (sub 32), the FOV cone off and priority to the right, K2, and K3 on
    the block_src 128 table; then a two-family pack through K1 (tile
    screen), K2 and K3."""
    import math

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    k1, k2, k3 = (PF.pair_forces_neighbors, PF.pair_forces_neighbors_unrolled,
                  PF.pair_forces_neighbors_db)
    full_fov = leg.with_params(BicycleParams.create(hfov=2 * math.pi))
    leg_t, fov_t, db_t = (sorted_inputs(e, state)
                          for e in (leg, full_fov, leg_db))
    two_t, two_db = two_family(leg, state), two_family(leg_db, state)
    bs64 = dict(block=BLOCK, block_src=BLOCK_SRC, mixed=True)
    bs128 = dict(block=BLOCK, block_src=DB_BLOCK, mixed=True)
    screen = dict(screen=True, cutoff=LEG_CUTOFF)
    k3_kw = {"block": BLOCK, "cutoff": LEG_CUTOFF, "mixed": True}
    k3_plain = {**bs128, **screen}
    forms = {
        "k1_mixed": (k1, leg_t, bs64, None),
        "k1_mixed_screen": (k1, leg_t, {**bs64, **screen}, None),
        "k1_mixed_screen_sub32": (k1, leg_t, {**bs64, **screen, "sub": 32},
                                  None),
        "k1_mixed_fov_off": (k1, fov_t, {**bs64, "fov": False}, None),
        "k1_mixed_p2r": (k1, leg_t, {**bs64, "priority_p2r": True}, None),
        "k2_mixed": (k2, leg_t, bs64, None),
        "k3_mixed": (k3, db_t, k3_kw, k3_plain),
        "k1_two_family_screen": (k1, two_t, {**bs64, **screen}, None),
        "k2_two_family": (k2, two_t, bs64, None),
        "k3_two_family": (k3, two_db, k3_kw, k3_plain),
    }
    out = {name: check_form("kernel_forms", name, fn, t, kw, plain or kw)
           for name, (fn, t, kw, plain) in forms.items()}
    k1_kw = {**bs64, **screen}
    ratios = {
        "k3_mixed": alternate("k1 mixed tile screen",
                              lambda: k1(*leg_t, **k1_kw),
                              "k3 mixed", lambda: k3(*db_t, **k3_kw)),
        "k2_mixed": alternate("k1 mixed", lambda: k1(*leg_t, **bs64),
                              "k2 mixed", lambda: k2(*leg_t, **bs64)),
    }
    return out, ratios


def phase_legacy_config(state):
    """The legacy path's engines: kb = the in-range maximum at t = 0
    (counted with a table of 4 * KB slots, itself overflow-free) plus
    KB_MARGIN, at block_src 64 (K1, K2) and at block_src 128 (K3)."""
    engines = []
    for block_src, backend in ((BLOCK_SRC, "pallas"), (DB_BLOCK,
                                                        "pallas_db")):
        probe = make_legacy_engine(block_src=block_src, kb=4 * KB)
        most = audit_overflow(probe, state,
                              f"legacy probe block_src {block_src} t=0")
        engines.append(make_legacy_engine(block_src=block_src,
                                          kb=most + KB_MARGIN,
                                          backend=backend))
    return engines


def phase_db_config(state):
    """The K3 path's engine: per-rider f_0 and sigma_0 on the card, block =
    block_src = 128, kb = the in-range maximum at t = 0 (counted with a
    table of 4 * KB slots, itself overflow-free) plus KB_MARGIN."""
    import torch

    params = jittered_params(state.n, "cuda", torch.float32)
    probe = make_engine(params, backend="pallas_db", block_src=DB_BLOCK,
                        kb=4 * KB, screen=True)
    most = audit_overflow(probe, state, "db probe t=0")
    return make_engine(params, backend="pallas_db", block_src=DB_BLOCK,
                       kb=most + KB_MARGIN, screen=True)


# each wrapper's kernel by the name a device trace shows it under
KERNEL_SYMBOLS = {"pair_forces_neighbors": "pair_forces_twod_kernel",
                  "pair_forces_neighbors_unrolled":
                      "pair_forces_unrolled_kernel",
                  "pair_forces_neighbors_db": "pair_forces_db_kernel"}


def traced_pair_kernels(engine, state, steps):
    """How often each pair kernel ran on the card in one graphed
    `simulate` of `steps` steps, read from a torch.profiler device trace:
    {wrapper name: kernel events}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.simulate(state, steps, record=False, graph=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not names:
        raise AssertionError("the trace holds no device activity")
    return {fn: sum(symbol in n for n in names)
            for fn, symbol in KERNEL_SYMBOLS.items()}


def phase_slice(phase, engine, state, kernel):
    """N_STEPS steps of `engine.simulate` as a user calls it (on the card
    each chunk is one CUDA-graph replay), each step through `kernel`.
    Every count is set to 0 just before the run. The wrappers count what
    they launch themselves, here the REBUILD steps of the capture's
    warm-up chunk; a replay runs no wrapper, so the engine counts its
    replays times the launches its capture recorded: exactly N_STEPS of
    `kernel` and none of the other kernels. A device trace of
    PROFILE_STEPS further graphed steps then shows that a replay does run
    that kernel once per step, and no other pair kernel. Also: a finite
    state, no table overflow at t = 0 and t = end. Then the eager loop and
    the graphed one timed in turns, three runs of each."""
    import torch

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    def named(counts):
        return dict(zip((fn.__name__ for fn in PF.KERNELS), counts))

    def only(n):
        return {fn.__name__: n * (fn is kernel) for fn in PF.KERNELS}

    audit_overflow(engine, state, f"{phase} t=0")
    torch.cuda.synchronize()
    if engine._runners:
        raise AssertionError(f"{phase}: the engine has captured already")
    PF.reset_launches()
    t0 = time.perf_counter()
    final, _ = engine.simulate(state, N_STEPS, record=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    warm_up = named(PF.launch_counts())
    launches = named(engine.graph_launches())
    finite = bool(torch.isfinite(final.s).all())
    runner, = engine._runners.values()
    if runner.graph is None or not runner.presorted:
        raise AssertionError(f"{phase}: the run did not go through a "
                             f"captured sorted-resident chunk")
    emit(f"{phase}_run", steps=N_STEPS, backend=engine.neighbors.backend,
         kernel_launches=launches, warm_up_launches=warm_up,
         replays=runner.replays, finite=finite, first_run_s=first_s,
         capture_s=runner.capture_seconds,
         captured_launches_per_replay=named(runner.captured))
    if launches != only(N_STEPS) or warm_up != only(REBUILD):
        raise AssertionError(
            f"{phase}: expected {only(N_STEPS)} replayed and "
            f"{only(REBUILD)} warm-up launches, counted {launches} and "
            f"{warm_up}")
    if not finite:
        raise AssertionError(f"{phase}: non-finite state after the run")
    audit_overflow(engine, final, f"{phase} t=end")

    PF.reset_launches()
    traced = traced_pair_kernels(engine, state, PROFILE_STEPS)
    replayed = {k: n - launches[k]
                for k, n in named(engine.graph_launches()).items()}
    by_wrapper = named(PF.launch_counts())
    emit(f"{phase}_trace", steps=PROFILE_STEPS, device_trace_kernels=traced,
         counted_replayed=replayed, counted_by_wrappers=by_wrapper)
    if not (traced == replayed == only(PROFILE_STEPS)
            and by_wrapper == only(0)):
        raise AssertionError(
            f"{phase}: the device trace of {PROFILE_STEPS} graphed steps "
            f"shows {traced}, the replay counters {replayed}, the "
            f"wrappers {by_wrapper}")

    runs = {"eager": [], "graphed": []}
    for _ in range(3):
        for how, graph in (("eager", False), ("graphed", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.simulate(state, N_STEPS, record=False, graph=graph)
            torch.cuda.synchronize()
            runs[how].append(time.perf_counter() - t0)
    if len(engine._runners) != 1:
        raise AssertionError(f"{phase}: the timed runs captured again")

    def ms(seconds):
        return 1e3 * seconds / N_STEPS

    dt = min(runs["graphed"])
    med = {how: ms(statistics.median(r)) for how, r in runs.items()}
    emit(phase, n_agents=N_AGENTS, n_padded=state.n, steps=N_STEPS,
         backend=engine.neighbors.backend, ms_per_step=ms(dt),
         agent_steps_per_s=N_AGENTS * N_STEPS / dt,
         median_ms_per_step=med,
         best_ms_per_step={how: ms(min(r)) for how, r in runs.items()},
         spread_ms_per_step={how: ms(max(r) - min(r))
                             for how, r in runs.items()},
         eager_over_graphed=med["eager"] / med["graphed"], runs_s=runs)
    return launches[kernel.__name__], warm_up[kernel.__name__]


def states_differ(a, b):
    """The fields in which two states are not bit-equal."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import _STATE_FIELDS

    return [f for f in _STATE_FIELDS
            if not torch.equal(getattr(a, f), getattr(b, f))]


def phase_graph_parity(paths, state):
    """The graphed run against the eager loop, bit for bit: on each path
    GRAPH_PARITY_STEPS steps from the 100,000-rider state without records
    and with the per-step metrics; on the main path's engine with the
    [T, N, 8] record on a GRAPH_PARITY_RECORD_N-rider crowd. And one eager
    chunk of the main path with every host synchronisation an error (what
    a capture would refuse)."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import permute_state
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    small = build_population(GRAPH_PARITY_RECORD_N, DENSITY, HIST_LEN, BLOCK,
                             torch.float32, "cuda")
    cases = [(name, engine, state, kw) for name, engine in paths.items()
             for kw in (dict(record=False),
                        dict(record=False, record_metrics=True))]
    cases.append(("slice", paths["slice"], small, dict(record=True)))
    for name, engine, st, kw in cases:
        eager, rec_e = engine.simulate(st, GRAPH_PARITY_STEPS, graph=False,
                                       **kw)
        graphed, rec_g = engine.simulate(st, GRAPH_PARITY_STEPS, graph=True,
                                         **kw)
        torch.cuda.synchronize()
        differ = states_differ(eager, graphed)
        if rec_e is not None and not torch.equal(rec_e, rec_g):
            differ.append("records")
        emit("graph_parity", path=name, n=st.n, steps=GRAPH_PARITY_STEPS,
             rebuild_every=REBUILD, options=kw, fields_differing=differ,
             records=None if rec_e is None else list(rec_e.shape))
        if differ:
            raise AssertionError(f"graph_parity {name} {kw}: the graphed "
                                 f"run differs from the eager loop in "
                                 f"{differ}")

    engine = paths["slice"]
    cache = engine.neighbor_cache(state)
    st = permute_state(state, cache[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.run_chunk(st, cache, REBUILD, presorted=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("graph_parity", check="one eager chunk under "
         "torch.cuda.set_sync_debug_mode('error')", steps=REBUILD,
         sync_points=0)


def phase_metrics(engine, state):
    """The per-step metrics of the main path at full width, through the
    sorted-resident graphed chunks."""
    import torch

    from cyclistsocialforce_tpu_torch.params import pair_hi, pair_lo

    names = engine.METRIC_NAMES
    t0 = time.perf_counter()
    _, m = engine.simulate(state, N_STEPS, record=False, record_metrics=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    cols = dict(zip(names, m.double().cpu().T))
    lo = pair_lo(engine.params.v_max_riding)
    hi = pair_hi(engine.params.v_max_riding)
    checks = {
        "shape": tuple(m.shape) == (N_STEPS, len(names)),
        "finite": bool(torch.isfinite(m).all()),
        "n_active": bool((cols["n_active"] == N_AGENTS).all()),
        "nbr_overflow": bool((cols["nbr_overflow"] == 0).all()),
        "v_max": bool(((cols["v_max"] >= lo) & (cols["v_max"] <= hi)).all()),
        "v_mean": bool(((cols["v_mean"] >= lo)
                        & (cols["v_mean"] <= cols["v_max"])).all()),
        "f_max": bool((cols["f_max"] >= cols["f_mean"]).all()),
    }
    emit("metrics", steps=N_STEPS, shape=list(m.shape), run_s=run_s,
         speed_limits=[lo, hi], checks=checks,
         last_row=dict(zip(names, m[-1].tolist())))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"metrics failed: {failed}")


def phase_aliasing(engine, state):
    """Two `simulate` calls on one engine from two different states, with
    the [T, 8] records: what the first call returned is unchanged after
    the second (a graph's outputs live in memory its next replay
    overwrites; `simulate` hands out copies)."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import _STATE_FIELDS

    s = state.s.clone()
    s[:, :2] += 1.5
    other = state.replace(s=s)
    kw = dict(record=False, record_metrics=True)
    first, m_first = engine.simulate(state, 2 * REBUILD, **kw)
    keep = {f: getattr(first, f).clone() for f in _STATE_FIELDS}
    m_keep = m_first.clone()
    second, _ = engine.simulate(other, 2 * REBUILD + 5, **kw)
    torch.cuda.synchronize()
    changed = [f for f in _STATE_FIELDS
               if not torch.equal(getattr(first, f), keep[f])]
    if not torch.equal(m_first, m_keep):
        changed.append("records")
    runs_differ = not torch.equal(first.s, second.s)
    emit("aliasing", steps=[2 * REBUILD, 2 * REBUILD + 5],
         first_call_changed=changed, runs_differ=runs_differ)
    if changed or not runs_differ:
        raise AssertionError(f"aliasing: the second simulate changed the "
                             f"first call's {changed} (runs differ: "
                             f"{runs_differ})")


def phase_profile(engine, state):
    """One torch.profiler window of PROFILE_STEPS graphed steps (two
    chunks, with their two table rebuilds) of the main path: device
    kernels and copies per step, host launches per step, device-busy ms
    per step, the card's idle share within the window, and the kernels
    by device time. The profiler slows the host's part (the rebuilds), so
    the same steps are also timed without it, and the device-busy time is
    given over that wall time too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.simulate(state, PROFILE_STEPS, record=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.simulate(state, PROFILE_STEPS, record=False)
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.simulate(state, PROFILE_STEPS, record=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = list(prof.events())
    device = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: e[:2])
    if not device:
        raise AssertionError("profile: the trace holds no device activity")
    busy_us, by_name = 0.0, {}
    window_start = reach = device[0][0]
    for start, end, name in device:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    window_us = reach - window_start
    host = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in (
                "cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync"):
            host[e.name] = host.get(e.name, 0) + 1
    pair_us = sum(t for n, t in by_name.items() if "pair_forces" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # what the host launched one by one ran outside the graphs (rebuilds,
    # permutations, the copies into the static buffers)
    eager_launches = sum(n for name, n in host.items()
                         if name != "cudaGraphLaunch")
    emit("profile", steps=PROFILE_STEPS, rebuilds=PROFILE_STEPS // REBUILD,
         wall_ms_per_step=1e3 * wall_s / PROFILE_STEPS,
         unprofiled_wall_ms_per_step=1e3 * plain_wall_s / PROFILE_STEPS,
         device_activities_per_step=len(device) / PROFILE_STEPS,
         graph_activities_per_step=(len(device) - eager_launches)
         / PROFILE_STEPS,
         host_calls=host,
         host_launches_per_step=sum(host.values()) / PROFILE_STEPS,
         device_busy_ms_per_step=1e-3 * busy_us / PROFILE_STEPS,
         window_ms_per_step=1e-3 * window_us / PROFILE_STEPS,
         idle_share=1.0 - busy_us / window_us,
         device_busy_over_unprofiled_wall=1e-6 * busy_us / plain_wall_s,
         pair_kernel_ms_per_step=1e-3 * pair_us / PROFILE_STEPS,
         other_ms_per_step=1e-3 * (busy_us - pair_us) / PROFILE_STEPS,
         top_kernels_ms_per_step={n[:80]: 1e-3 * t / PROFILE_STEPS
                                  for n, t in top})


def compare_runs(phase, engine_a, state_a, engine_b, state_b, **info):
    """PARITY_STEPS steps of two engine/state pairs, final states held to
    the two-tier tolerance (`parity_errors`); emits one line."""
    import torch

    fin_a, _ = engine_a.simulate(state_a, PARITY_STEPS, record=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin_b, _ = engine_b.simulate(state_b, PARITY_STEPS, record=False)
    torch.cuda.synchronize()
    errs = parity_errors(fin_a, fin_b)
    emit(phase, steps=PARITY_STEPS, rebuild_every=REBUILD,
         second_run_s=time.perf_counter() - t0, **info, **errs)
    if errs["failed"]:
        raise AssertionError(f"{phase} failed: {errs['failed']}")


def phase_parity():
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    engine = make_engine()
    st_gpu = build_population(PARITY_N, DENSITY, HIST_LEN, BLOCK,
                              torch.float32, "cuda")
    st_cpu = build_population(PARITY_N, DENSITY, HIST_LEN, BLOCK,
                              torch.float64, "cpu")
    audit_overflow(engine, st_gpu, "parity t=0")
    compare_runs("parity", engine, st_gpu, engine, st_cpu, n=PARITY_N,
                 runs="card float32 K1 vs CPU float64 plain")


def phase_parity_db(db_engine, state):
    """The K3 path against K1 in the same screened per-column form on the
    card (the slice_db crowd), then against the CPU float64 plain version
    on a PARITY_DB_N-rider crowd."""
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    cfg = db_engine.neighbors
    k1 = make_engine(db_engine.params, block_src=DB_BLOCK, kb=cfg.kb,
                     screen=True)
    compare_runs("parity_db", db_engine, state, k1, state, n=state.n,
                 runs="card K3 vs card K1 (screen, block_src 128)")

    st_gpu = build_population(PARITY_DB_N, DENSITY, HIST_LEN, BLOCK,
                              torch.float32, "cuda")
    st_cpu = build_population(PARITY_DB_N, DENSITY, HIST_LEN, BLOCK,
                              torch.float64, "cpu")
    gpu = db_engine.with_params(jittered_params(st_gpu.n, "cuda",
                                                torch.float32))
    cpu = db_engine.with_params(jittered_params(st_cpu.n, "cpu",
                                                torch.float64))
    audit_overflow(gpu, st_gpu, "parity_db t=0")
    compare_runs("parity_db", gpu, st_gpu, cpu, st_cpu, n=PARITY_DB_N,
                 runs="card float32 K3 vs CPU float64 plain")


def phase_parity_legacy(engine):
    """The slice_legacy configuration on a PARITY_LEG_N-rider crowd, 45
    steps: the card in float32 (K1, mixed form, tile screen) against the
    plain version on the CPU in float32 (both tiers) and in float64 (the
    cap), see LEG_CUTOFF."""
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    def run(dtype, device):
        st = build_population(PARITY_LEG_N, DENSITY, HIST_LEN, BLOCK, dtype,
                              device)
        if device == "cuda":
            audit_overflow(engine, st, "parity_legacy t=0")
        t0 = time.perf_counter()
        fin, _ = engine.simulate(st, PARITY_STEPS, record=False)
        torch.cuda.synchronize()
        return fin, time.perf_counter() - t0

    card, _ = run(torch.float32, "cuda")
    cpu32, s32 = run(torch.float32, "cpu")
    cpu64, s64 = run(torch.float64, "cpu")
    vs32 = parity_errors(card, cpu32)
    vs64 = parity_errors(card, cpu64)
    base = parity_errors(cpu32, cpu64)
    over_cap = [k for k in vs64["failed"]
                if k not in vs64["max"] or vs64["max"][k] > PARITY_CAP[k]]
    info = dict(steps=PARITY_STEPS, rebuild_every=REBUILD, n=PARITY_LEG_N)
    emit("parity_legacy", runs="card float32 K1 mixed vs CPU float32 "
         "plain", cpu_run_s=s32, **info, **vs32)
    emit("parity_legacy", runs="card float32 K1 mixed vs CPU float64 "
         "plain (enforced: the cap)", cpu_run_s=s64, **info, **vs64,
         over_cap=over_cap, cpu_float32_vs_float64={
             k: base[k] for k in ("max", "p99.9", "n_over_tol", "failed")})
    if vs32["failed"] or over_cap:
        raise AssertionError(f"parity_legacy failed: float32 "
                             f"{vs32['failed']}, float64 cap {over_cap}")


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
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", name=name, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t_start = t0 = time.perf_counter()
    lib = _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, library=lib._name)

    engine = make_engine()
    state = build_population(N_AGENTS, DENSITY, HIST_LEN, BLOCK,
                             torch.float32, "cuda")
    db_engine = phase_db_config(state)
    leg_engine, leg_db_engine = phase_legacy_config(state)
    kernel = phase_kernel(engine, state)
    forms, vs_k1 = phase_kernel_forms(engine, db_engine, state)
    mixed_forms, mixed_vs_k1 = phase_mixed_forms(leg_engine, leg_db_engine,
                                                 state)
    forms.update(mixed_forms)
    vs_k1.update(mixed_vs_k1)
    paths = {"slice": engine,
             "slice_unrolled": make_engine(backend="pallas_unrolled"),
             "slice_db": db_engine, "slice_legacy": leg_engine}
    launches = {
        "k1": phase_slice("slice", engine, state, PF.pair_forces_neighbors),
        "k2": phase_slice("slice_unrolled", paths["slice_unrolled"], state,
                          PF.pair_forces_neighbors_unrolled),
        "k3": phase_slice("slice_db", db_engine, state,
                          PF.pair_forces_neighbors_db),
        "k1_legacy": phase_slice("slice_legacy", leg_engine, state,
                                 PF.pair_forces_neighbors),
    }
    phase_parity()
    phase_parity_db(db_engine, state)
    phase_parity_legacy(leg_engine)
    phase_graph_parity(paths, state)
    phase_metrics(engine, state)
    phase_aliasing(engine, state)
    phase_profile(engine, state)
    emit("total", seconds=time.perf_counter() - t_start)

    def mixed(form, launched=(None, None)):
        return {"form": form, **counted(launched), **forms[form]}

    def counted(pair):
        """A path's (replayed, warm-up) launches of its kernel."""
        return {"launches": pair[0], "warm_up_launches": pair[1]}

    # vs_k1: K1's time over the kernel's on the same work in the same call
    print(json.dumps({"kernels": [
        {"name": "pair_forces_neighbors", "route": "cuda",
         "source": SRC + "pair_forces.cu", "replaces": TPU + "75",
         **counted(launches["k1"]), **kernel,
         "vs_k2_uniform": vs_k1["k2_uniform"],
         "mixed": {**mixed("k1_mixed_screen", launches["k1_legacy"]),
                   "vs_k3_mixed": vs_k1["k3_mixed"]}},
        {"name": "pair_forces_neighbors_unrolled", "route": "cuda",
         "source": SRC + "pair_forces_unrolled.cu", "replaces": TPU + "401",
         **counted(launches["k2"]), **forms["k2_uniform"],
         "vs_k1": vs_k1["k2_uniform"],
         "mixed": {**mixed("k2_mixed"), "vs_k1": vs_k1["k2_mixed"]}},
        {"name": "pair_forces_neighbors_db", "route": "cuda",
         "source": SRC + "pair_forces_db.cu", "replaces": TPU + "500",
         **counted(launches["k3"]), **forms["k3"],
         "vs_k1": vs_k1["k3"],
         "mixed": {**mixed("k3_mixed"), "vs_k1": vs_k1["k3_mixed"]}},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
