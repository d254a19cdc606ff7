"""Dry runs of the sharded schedules, each held to the single-device run.

Counterparts of `__graft_entry__.dryrun_multichip` and
`dryrun_multiprocess` of the JAX package:

    dryrun_multichip(n_shards, device)      one process holding every
                                            shard on `device`
    dryrun_multiprocess(n_procs, shards_per_proc, device)
                                            `n_procs` processes in one
                                            process group (Gloo on the
                                            CPU, NCCL on the card)

Every check compares the sharded final state with the port's
single-device `Engine.simulate` of the same population and asserts the
schedule's bound: a run that does not crash does not pass by itself.

The multi-process run starts its workers as `python -m
cyclistsocialforce_tpu_torch.parallel.dryrun --worker ...`; they meet
through a `torch.distributed.FileStore` in a fresh temporary directory,
so two dry runs at once never share a port, and every worker still
running when one fails is killed.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

N_STEPS = 4
# on the card the culled pairs are the CUDA kernel's float32 sums, which
# another block partition re-associates: the culled and mixed checks
# there hold to this bound (an H100 run of dryrun_multichip(4) and (8):
# 1.2e-7 to 1.5e-7 culled, 1.3e-7 to 7.9e-7 mixed), where the CPU's
# float64 plain version holds to JAX's 1e-9 and 1e-12. The halo schedule
# keeps the single-device table and its order: 0 on either device
CARD_PAIR_ATOL = 1e-5


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "dry run on the CPU")
    return device


def _block(device) -> int:
    """The receiver block: the JAX dry run's 8 on the CPU (the plain
    version takes any), the kernels' smallest, 64, on the card."""
    return 8 if device.type == "cpu" else 64


def _check(tag, label, got, want, atol):
    err = float((got.s - want.s).abs().max())
    ok = err <= atol
    print(f"{label}, {tag}: max |state - single-device| = {err:.3e} "
          f"(bound {atol:.0e}) -> {'ok' if ok else 'FAIL'}", flush=True)
    assert ok, (f"{tag}: sharded state deviates from single-device by "
                f"{err:.3e} > {atol:.0e}")


def _flagship(n, device, stochastic=False):
    """The Whipple-stable balancing-rider crowd of the JAX dry run
    (`_build_flagship`), float64, and its engine."""
    from cyclistsocialforce_tpu_torch import Engine
    from cyclistsocialforce_tpu_torch.models import MODELS, prepare
    from cyclistsocialforce_tpu_torch.params import BalancingRiderParams
    from cyclistsocialforce_tpu_torch.scenarios import build_flagship_crowd

    model = MODELS["balancingrider"]
    st = build_flagship_crowd(n, None, 8, None, torch.float64, device,
                              model=None)
    if stochastic:
        p = BalancingRiderParams.create(
            stochastic_control_behavior=True, resample_budget=4,
            resample_every=2, p_dist_roll=0.05, T_dist_roll=20.0,
            verbose=False)
    else:
        p = BalancingRiderParams.create(verbose=False)
    return Engine.create(p, model), prepare(model, p, st)


def _mixed_crowd(n_m, device, block):
    """The JAX dry run's heterogeneous crowd: random bicycle2d rows
    (legacy field), Whipple-stable balancing riders (twod field) and a
    scripted car, culled over the whole domain."""
    from cyclistsocialforce_tpu_torch import NeighborConfig
    from cyclistsocialforce_tpu_torch.engine import ScriptedTraj
    from cyclistsocialforce_tpu_torch.mixed import (MixedEngine,
                                                    prepare_groups)
    from cyclistsocialforce_tpu_torch.params import (BalancingRiderParams,
                                                     BicycleParams,
                                                     as_population)
    from cyclistsocialforce_tpu_torch.state import make_state

    n_a = n_m // 2
    rng = np.random.default_rng(12)
    s0 = np.zeros((n_m, 5))
    s0[:n_a, 0] = rng.uniform(0, 60, n_a)
    s0[:n_a, 1] = rng.uniform(0, 60, n_a)
    s0[:n_a, 2] = rng.uniform(-np.pi, np.pi, n_a)
    s0[:n_a, 3] = rng.uniform(1, 6, n_a)
    s0[n_a:, 0] = rng.uniform(0, 60, n_m - n_a)
    s0[n_a:, 1] = rng.uniform(0, 60, n_m - n_a)
    s0[n_a:, 2] = rng.uniform(-0.2, 0.2, n_m - n_a)
    s0[n_a:, 3] = rng.uniform(4, 6, n_m - n_a)
    st = make_state(s0, dtype=torch.float64, hist_len=8, device=device)
    dst = torch.as_tensor(np.c_[s0[:, 0] + 100, s0[:, 1], np.zeros(n_m)],
                          device=device)
    dq = st.destqueue.clone()
    dq[:, 0, :] = dst
    st = st.replace(dest=dst, destqueue=dq)
    car = np.zeros((N_STEPS + 2, 4))
    car[:, 0] = s0[0, 0] + 0.08 * np.arange(1, N_STEPS + 3)
    car[:, 1] = s0[0, 1]
    car[:, 3] = 8.0
    scripted = ScriptedTraj.create(n_m, {0: car}, torch.float64, device)
    me = MixedEngine.create(
        [("bicycle2d", as_population(BicycleParams.create(), n_a, device),
          n_a),
         ("balancingrider", BalancingRiderParams.create(verbose=False),
          n_m - n_a)],
        scripted=scripted,
        neighbors=NeighborConfig(cutoff=1e4, block=block,
                                 kb=n_m // block, rebuild_every=2))
    return me, prepare_groups(me, st)


def dryrun_multichip(n_shards: int, device="cuda") -> None:
    """Run every sharded schedule over `n_shards` shards held by this
    process on `device` and hold each to the single-device run of the
    same population: the dense allgather (1e-12) and ring (1e-9), the
    culled allgather (1e-9), the halo schedule (1e-12, no window
    overflow, a halo narrower than a strip), the balancing rider exact
    and stochastic (1e-12) and a two-family MixedEngine crowd with a
    scripted car (1e-12). On the card the culled allgather and the mixed
    crowd hold to CARD_PAIR_ATOL (float32 pair sums in another order)."""
    from cyclistsocialforce_tpu_torch import Engine, NeighborConfig
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams
    from cyclistsocialforce_tpu_torch.parallel import (
        gather_state, make_mesh, required_halo, shard_state,
        sharded_simulate_fn)
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    device = _device(device)
    blk = _block(device)
    card = device.type == "cuda"
    label = f"dryrun_multichip({n_shards}, {device})"
    mesh = make_mesh(n_shards, device=device)

    def sharded(engine, state, **kw):
        run = sharded_simulate_fn(engine, mesh, N_STEPS, **kw)
        out = run(shard_state(state, mesh))
        return gather_state(out[0], mesh), out[1]

    def single(engine, state):
        return engine.simulate(state, N_STEPS, record=False)[0]

    state = build_population(blk * n_shards, None, 128, None, torch.float64,
                             device)
    engine = Engine.create(BicycleParams.create(), MODELS["bicycle2d"])
    ref = single(engine, state)
    # the dense schedules: allgather sums in index order, the ring
    # re-associates the source sum per hop
    for comm, atol in (("allgather", 1e-12), ("ring", 1e-9)):
        _check(comm, label, sharded(engine, state, comm=comm)[0], ref, atol)

    culled = Engine.create(
        BicycleParams.create(), MODELS["bicycle2d"], rep_force="twod",
        neighbors=NeighborConfig(cutoff=60.0, block=blk, kb=8 * n_shards,
                                 rebuild_every=2))
    _check("culled", label, sharded(culled, state)[0],
           single(culled, state), CARD_PAIR_ATOL if card else 1e-9)

    # the halo schedule on a spread-out crowd whose strips span several
    # cell columns, so the window is a strict subset of a strip
    st_h = build_population(64 * blk * n_shards, 0.02, 128, None,
                            torch.float64, device)
    eng_h = Engine.create(
        BicycleParams.create(), MODELS["bicycle2d"], rep_force="twod",
        neighbors=NeighborConfig(cutoff=20.0, block=blk, kb=64,
                                 rebuild_every=2))
    h = required_halo(eng_h, st_h, n_shards) + 1
    strip_blocks = st_h.n // n_shards // eng_h.neighbors.block_src
    assert h < strip_blocks, (
        f"degenerate halo geometry: halo {h} >= strip {strip_blocks}")
    print(f"{label}, halo geometry: {h} src blocks/side of a "
          f"{strip_blocks}-block strip", flush=True)
    final, ovf = sharded(eng_h, st_h, comm="halo", halo=h)
    assert not bool(ovf), "halo window overflow"
    _check(f"halo (halo={h} src blocks)", label, final, single(eng_h, st_h),
           1e-12)

    for tag, stochastic in (("flagship", False),
                            ("flagship-stochastic", True)):
        engf, stf = _flagship(8 * n_shards, device, stochastic)
        _check(tag, label, sharded(engf, stf)[0], single(engf, stf), 1e-12)

    me, stm = _mixed_crowd(blk * n_shards, device, blk)
    _check("mixed+scripted (2 families)", label, sharded(me, stm)[0],
           single(me, stm), CARD_PAIR_ATOL if card else 1e-12)


def _worker(rank: int, n_procs: int, shards_per_proc: int, store: str,
            device: str) -> None:
    """One process of the multi-process dry run: joins the group, builds
    the same populations from fixed seeds, runs the sharded schedules
    over the process-spanning mesh and holds its local shards to its own
    single-device run."""
    import torch.distributed as dist

    from cyclistsocialforce_tpu_torch import Engine
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams
    from cyclistsocialforce_tpu_torch.parallel import (
        make_mesh, shard_state, sharded_simulate_fn)
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store, n_procs),
                            rank=rank, world_size=n_procs)
    try:
        n_shards = n_procs * shards_per_proc
        mesh = make_mesh(n_shards, device=dev, group=dist.group.WORLD)

        def check(tag, engine, state):
            ref, _ = engine.simulate(state, N_STEPS, record=False)
            run = sharded_simulate_fn(engine, mesh, N_STEPS)
            final, _ = run(shard_state(state, mesh))
            nl = state.n // n_shards
            err = max(float((f.s - ref.s[d * nl:(d + 1) * nl]).abs().max())
                      for d, f in zip(mesh.shards, final))
            ok = err <= 1e-12
            print(f"[proc {rank}/{n_procs}] {tag}: local-shard max err "
                  f"{err:.3e} -> {'ok' if ok else 'FAIL'}", flush=True)
            assert ok, (tag, err)

        check("allgather x-process",
              Engine.create(BicycleParams.create(), MODELS["bicycle2d"]),
              build_population(8 * n_shards, None, 128, None,
                               torch.float64, dev))
        check("flagship x-process", *_flagship(8 * n_shards, dev))
    finally:
        dist.destroy_process_group()


def run_workers(argv, n_procs: int, timeout: float = 600.0) -> list:
    """Start `n_procs` Python processes `python -m <argv> <rank> <store>`
    (the store a fresh FileStore path, the package importable), wait for
    all, and return their outputs. A worker that fails, or the timeout,
    kills the rest: no worker outlives the call."""
    root = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory(prefix="csf_store_") as tmp:
        store = os.path.join(tmp, "store")
        procs = []
        try:
            for rank in range(n_procs):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", *argv, str(rank), store],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env))
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        sys.stdout.write(out)
        if p.returncode != 0:
            raise RuntimeError(f"worker {rank} failed (rc={p.returncode}):"
                               f"\n{out[-2000:]}")
    return outs


def dryrun_multiprocess(n_procs: int = 2, shards_per_proc: int = 2,
                        device="cuda") -> None:
    """`n_procs` processes in one process group (NCCL, one card each, on
    CUDA; Gloo on the CPU) over a mesh of n_procs * shards_per_proc
    shards: the dense allgather schedule and the balancing rider, each
    process's shards held to its own single-device run at 1e-12."""
    device = _device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_procs:
        raise ValueError(f"{n_procs} NCCL ranks need {n_procs} cards, "
                         f"this machine has {torch.cuda.device_count()}: "
                         f"run the processes on the CPU (device='cpu')")
    outs = run_workers(
        ["cyclistsocialforce_tpu_torch.parallel.dryrun", "--worker",
         str(n_procs), str(shards_per_proc), device.type], n_procs)
    assert all("-> ok" in o for o in outs)
    print(f"dryrun_multiprocess({n_procs} procs x {shards_per_proc} "
          f"shards, {device.type}): ok", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        n, k, dev, rank, store = sys.argv[2:7]
        _worker(int(rank), int(n), int(k), store, dev)
