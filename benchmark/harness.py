"""One run of one cell: set-up, the measured window, the traced episode, and
the comparison with the plain reference that decides `correct`.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell lives in files of its own, found by the names in BENCHMARK.json:
`configs/<config>.json`, `traffic/<mix>.json` (whose `generator` names a
module of `generators/`), `layer_metrics/<metric>.py` and
`limits/<cell>.json`.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from benchmark.peaks import PEAKS

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# top-level module names that may not be loaded when the result is printed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cyclistsocialforce_tpu")
# chunks of the window compared with the reference besides its first one,
# drawn from the seed (reservoir sampling over every chunk of the window)
CHECKED_DRAWN = 3
# rows of each answer's widest gaps that the readings keep
TOP_ROWS = 64
# what the comparison reads from a program state (AgentState attributes),
# besides the fields that the reference's model module names
# (`reference.step.extra_fields`)
STATE_FIELDS = ("s", "dyn_x", "dyn_gains", "pid_e", "pid_i", "dest",
                "destqueue", "destpointer", "nq", "i", "znav", "znavparams",
                "active")


# ---- the cell's files -----------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, spec: dict | None = None):
    """(cell, configuration, traffic mix, limits) of the cell `name`."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / conf["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            load_json(BENCH / "limits" / f"{name}.json"))


def cell_metrics(name: str, spec: dict, group: str) -> list:
    """The metrics of `group` ("end_to_end" or "per_layer") that
    BENCHMARK.json gives cell `name`."""
    return [m for m in spec[group] if name in m.get("workloads", [name])]


def load_reader(metric: str):
    """The reader module of per-layer metric `metric`."""
    path = BENCH / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.layer_metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generate(mix: dict, seed: int) -> dict:
    gen = importlib.import_module(f"benchmark.generators.{mix['generator']}")
    return gen.generate(mix, seed)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


# ---- the program under test -----------------------------------------------

def build_program(cfg: dict, inputs: dict, device):
    """The port's engine and initial state for the configuration `cfg` on
    the generated `inputs`: each rider's destination, or, where the
    traffic has `waypoints` [rows, K, 2], its route of K queued
    destinations with the pointer at the first."""
    import torch

    from cyclistsocialforce_tpu_torch import params as P
    from cyclistsocialforce_tpu_torch.engine import Engine, NeighborConfig
    from cyclistsocialforce_tpu_torch.models import MODELS, prepare
    from cyclistsocialforce_tpu_torch.state import make_state

    dtype = getattr(torch, cfg["dtype"])
    model = MODELS[cfg["model"]]
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["params"].items()}
    params = getattr(P, cfg["params_class"]).create(**cfg.get("create", {}),
                                                      **kw)
    rows = inputs["rows"]
    state = make_state(inputs["s0"], int(cfg.get("queue_size", 16)),
                       int(cfg["hist_len"]), dtype=dtype, model=model,
                       device=device)
    dest = torch.zeros((rows, 3), dtype=dtype, device=device)
    dest[:, :2] = torch.as_tensor(inputs["dest"], dtype=dtype, device=device)
    queue = state.destqueue.clone()
    queue[:, 0] = dest
    nq = state.nq
    if "waypoints" in inputs:
        k = inputs["waypoints"].shape[1]
        queue[:, :k, :2] = torch.as_tensor(inputs["waypoints"], dtype=dtype,
                                           device=device)
        dest = queue[:, 0].clone()
        nq = torch.full_like(nq, k)
    active = torch.arange(rows, device=device) < inputs["n_riders"]
    state = prepare(model, params, state.replace(
        destqueue=queue, dest=dest, nq=nq, active=active))
    engine = Engine.create(params, model, rep_force=cfg["rep_force"],
                           dest_force=cfg["dest_force"],
                           neighbors=NeighborConfig(**cfg["neighbors"]))
    return engine, state


def episode_sound(engine, state) -> bool:
    """No non-finite state and no neighbor-table overflow at an episode's
    end (the table built as the next rebuild would build it)."""
    import torch

    cache = engine.neighbor_cache(state)
    bad = (cache[3].sum() > 0) | ~torch.isfinite(state.s).all()
    return not bool(bad)


# ---- the window -----------------------------------------------------------

class Sample:
    """The window's first chunk and CHECKED_DRAWN more drawn uniformly
    from all of its chunks (reservoir sampling from the seed): (chunk of
    its episode, input state, output state). Holding the states costs no
    copy: every chunk returns fresh tensors."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.first = None
        self.drawn = []
        self.seen = 0

    def offer(self, item):
        if self.first is None:
            self.first = item
            return
        self.seen += 1
        if len(self.drawn) < CHECKED_DRAWN:
            self.drawn.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < CHECKED_DRAWN:
                self.drawn[j] = item

    def items(self):
        return ([self.first] if self.first else []) + self.drawn


def run_window(scen, engine, mix: dict, seconds: float, seed: int,
               trace: bool):
    """Closed-loop chunks of `Scenario.step_chunk` for `seconds`, the
    episodes restarted from the seeded crowd; with `trace` the second
    episode runs under torch.profiler. Returns a dict of the window's
    readings."""
    import torch

    chunk = int(mix["chunk_steps"])
    per_episode = int(mix["episode_steps"]) // chunk
    sample = Sample(seed)
    walls, attempted, failed = [], 0, 0
    prof, profiled, boundary = None, None, []
    t_start = time.perf_counter()
    while True:
        c = attempted % per_episode
        episode = attempted // per_episode
        if c == 0:
            scen.reset()
            if trace and episode == 1:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                boundary = [_positions(scen.state)]
        state_in = scen.state
        t0 = time.perf_counter()
        scen.step_chunk(record=False)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        attempted += 1
        sample.offer((c, state_in, scen.state))
        if prof is not None:
            boundary.append(_positions(scen.state))
        if c == per_episode - 1:
            # the profiler closes before the audit: its table build is
            # the harness's, not the program's
            if prof is not None:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                profiled, prof = (prof, boundary), None
            if not episode_sound(engine, scen.state):
                failed += per_episode
        if time.perf_counter() - t_start >= seconds and prof is None:
            break
    partial = attempted % per_episode
    if partial and not episode_sound(engine, scen.state):
        failed += partial
    window_s = time.perf_counter() - t_start
    return {"walls": walls, "attempted": attempted, "failed": failed,
            "window_s": window_s, "sample": sample, "profiled": profiled,
            "steps": attempted * chunk}


def _positions(state):
    """What the pair count reads of a state: its rows' positions,
    activity and queue pointers (references, no copy)."""
    return {"s": state.s, "active": state.active,
            "destpointer": state.destpointer, "nq": state.nq}


# ---- the comparison with the reference ------------------------------------

def reference_input(st, dtype, model: str):
    """A program state's fields as the reference's state of model
    `model` (a reference module's name, `reference.step.reference_model`),
    in `dtype`."""
    from benchmark.reference import step as R

    fields = STATE_FIELDS + R.extra_fields(model)
    return R.cast({f: getattr(st, f) for f in fields}, dtype)


def row_gaps(answer: dict, want: dict):
    """Per active row, the gap between an answer's state and the
    reference's: in position (m) and in velocity vector (m/s).
    Non-finite values read as infinite."""
    import torch

    act = want["active"]
    a, w = answer["s"].double()[act], want["s"].double()[act]

    def vel(s):
        return torch.stack([s[:, 3] * torch.cos(s[:, 2]),
                            s[:, 3] * torch.sin(s[:, 2])], dim=1)

    out = []
    for d in (a[:, :2] - w[:, :2], vel(a) - vel(w)):
        d = torch.hypot(d[:, 0], d[:, 1])
        out.append(torch.where(torch.isfinite(d), d, float("inf")))
    return out


def gap_numbers(dpos, dvel, far_pos_m: float) -> dict:
    """The numbers of one chunk's row gaps: their 99.9th percentiles,
    `far_rows`, the rows whose position gap passes `far_pos_m`, and the
    widest gaps (which swing with the crowd's chaotic encounters,
    PERF.md)."""
    import torch

    def p999(d):
        return float(torch.quantile(d, 0.999, interpolation="higher"))

    return {"pos_gap_p999_m": p999(dpos), "vel_gap_p999_mps": p999(dvel),
            "far_rows": float((dpos > far_pos_m).sum()),
            "pos_gap_max_m": float(dpos.max()),
            "vel_gap_max_mps": float(dvel.max())}


def gap_detail(dpos, dvel) -> dict:
    """What the limits are set from besides the numbers: the medians, the
    rows over a few gaps, and the (position, velocity) gaps of the rows
    widest in either."""
    import torch

    top = torch.cat([torch.topk(d, min(TOP_ROWS, d.numel())).indices
                     for d in (dpos, dvel)]).unique()
    return {"pos_gap_p50_m": float(dpos.median()),
            "vel_gap_p50_mps": float(dvel.median()),
            "rows_pos_over_m": {str(x): int((dpos > x).sum())
                                for x in (0.5, 1, 2, 3, 5)},
            "rows_vel_over_mps": {str(x): int((dvel > x).sum())
                                  for x in (1, 2, 4, 6, 8)},
            "top_rows": [[float(dpos[i]), float(dvel[i])] for i in top]}


def compare(items, cfg: dict, inputs: dict, steps: int, device,
            far_pos_m: float, answers=(None,), detail: bool = False) -> dict:
    """For each answer, the worst numbers (`gap_numbers`) over the sampled
    chunks `items` ((chunk of its episode, input state, output state))
    between what answered and the float64 reference run over the same
    steps from the same input. An answer is the program's output state
    (None) or the reference itself computed in the dtype named. A chunk
    that starts an episode starts the reference from its own initial
    state, built from the generated inputs; the others from the program's
    input state. With `detail`, each answer also keeps every chunk's
    `gap_detail`."""
    import torch

    from benchmark.reference import step as R

    c64 = R.constants(cfg, torch.float64, device)
    cs = {a: R.constants(cfg, getattr(torch, a), device)
          for a in answers if a is not None}
    worst = {a or "program": {} for a in answers}
    for c, st_in, st_out in items:
        if c == 0:
            start = R.initial_state(cfg, c64, inputs["s0"], inputs["dest"],
                                    inputs["n_riders"], torch.float64,
                                    device, inputs.get("waypoints"))
        else:
            start = reference_input(st_in, torch.float64,
                                    R.reference_model(cfg))
        want = R.run(start, c64, steps)
        for a in answers:
            if a is None:
                answer = {"s": st_out.s}
            else:
                answer = R.run(R.cast(start, getattr(torch, a)), cs[a], steps)
            dpos, dvel = row_gaps(answer, want)
            w = worst[a or "program"]
            for k, v in gap_numbers(dpos, dvel, far_pos_m).items():
                w[k] = max(w.get(k, 0.0), v)
            if detail:
                w.setdefault("chunks", []).append(gap_detail(dpos, dvel))
            del answer, dpos, dvel
        del want
    return worst


# ---- one run ---------------------------------------------------------------

def device_info(chips: int, device) -> dict:
    import torch

    info = {"platform": "gpu" if torch.device(device).type == "cuda"
            else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if torch.device(device).type == "cuda" else "cpu"),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def trace_context(profiled, cfg: dict, inputs: dict, mix: dict,
                  summary: dict) -> dict:
    """What the per-layer readers take: the trace's summary and the
    profiled episode's sizes, with its pair count."""
    import torch

    from benchmark.reference import grid

    _, boundary = profiled
    cutoff = float(cfg["neighbors"]["cutoff"])
    counts = [grid.count_pairs_within(st["s"][:, 0], st["s"][:, 1], cutoff,
                                      st["active"]) for st in boundary]
    chunk = int(mix["chunk_steps"])
    pairs = sum(chunk * 0.5 * (a + b) for a, b in zip(counts, counts[1:]))
    st0 = boundary[0]
    n_next = int((st0["destpointer"] + 1 < st0["nq"])[st0["active"]].sum())
    return {**summary, "config": cfg, "steps": chunk * (len(boundary) - 1),
            "rows": inputs["rows"], "n_active": int(st0["active"].sum()),
            "n_next": n_next, "hist_len": int(cfg["hist_len"]),
            "pairs": pairs,
            "pairs_per_step": pairs / (chunk * (len(boundary) - 1))}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_process: float | None = None,
             readings: tuple | None = None) -> tuple:
    """One run of cell `name`: (result dict, the lines of the checks).
    `readings` (never set by the benchmark's own runs) names the dtypes in
    which the reference also answers in the program's place, and keeps
    each answer's `gap_detail`: what the limits are set from
    (`control.py`)."""
    t_process = time.perf_counter() if t_process is None else t_process
    import torch

    from cyclistsocialforce_tpu_torch.scenario import Scenario

    spec = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, mix, limits = cell_files(name, spec)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    info = device_info(int(cell["chips"]), device)
    inputs = generate(mix, seed)
    engine, state = build_program(cfg, inputs, device)
    scen = Scenario(engine, state, t_s=float(cfg["params"]["t_s"]),
                    chunk=int(mix["chunk_steps"]),
                    run_time_factor=mix.get("run_time_factor"))
    # warm-up: one chunk (the chunk graph's capture) and an episode-end
    # audit, then back to the seeded crowd
    scen.step_chunk(record=False)
    episode_sound(engine, scen.state)
    scen.reset()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    win = run_window(scen, engine, mix, seconds, seed, trace)
    if on_card:
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    else:
        info["memory_peak_bytes"] = 0
    result = {"correct": None, "attempted": win["attempted"],
              "failed": win["failed"]}
    extra = {}
    if trace:
        metrics = {}
        if win["profiled"] is not None:
            from benchmark.trace import summarize

            summary = summarize(win["profiled"][0])
            ctx = trace_context(win["profiled"], cfg, inputs, mix, summary)
            for m in cell_metrics(name, spec, "per_layer"):
                value = load_reader(m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
            info["busy_s"] = 1e-6 * ctx["busy_us"]
            info["window_s"] = 1e-6 * ctx["window_us"]
            extra["breakdown"] = summary["breakdown"]
            extra["trace_sizes"] = {"steps": ctx["steps"],
                                    "pairs_per_step": ctx["pairs_per_step"],
                                    "peaks": dict(PEAKS),
                                    "power_limit_w": info["power_limit_w"]}
    else:
        walls_ms = 1e3 * np.asarray(win["walls"])
        values = {"agent_steps_per_s": int(inputs["n_riders"]) * win["steps"]
                  / win["window_s"],
                  "chunk_ms_p95": float(np.percentile(walls_ms, 95)),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(name, spec, "end_to_end")}
        # the shape of the chunks' wall times, for the reader of the ledger
        extra["chunk_ms"] = {f"p{q}": float(np.percentile(walls_ms, q))
                             for q in (5, 50, 90, 99)}

    # the program's state is freed before the reference runs
    items = win["sample"].items()
    del scen, engine, state, win
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    got = compare(items, cfg, inputs, int(mix["chunk_steps"]), device,
                  limits["far_pos_m"], (None,) + tuple(readings or ()),
                  detail=readings is not None)
    extra["reference_s"] = time.perf_counter() - t_ref
    worst = {**got.pop("program"), "failed_chunks": result["failed"]}
    if readings is not None:
        extra["readings"] = {"program": worst, **got}
    extra["widest_gaps"] = {k: worst[k] for k in ("pos_gap_max_m",
                                                  "vel_gap_max_mps")}
    checks = {k: {"value": worst[k], "limit": v}
              for k, v in limits["checks"].items()}
    result["correct"] = all(v["value"] <= v["limit"] for v in checks.values())
    result.update(metrics=metrics, device=info, **extra, checks=checks)
    lines = [f"{k} {v['value']!r} limit {v['limit']!r}"
             for k, v in checks.items()]
    return result, lines
