"""Sharding demo: one crowd over a mesh of shards.

Shows the `cyclistsocialforce_tpu_torch.parallel` surface end to end:
build a culled engine, split the population into `--devices` shards, run
the chosen schedule, and check the result against the single-device run.
One process holds every shard on `--device` (the card: the pair stage of
each shard through K1); `--procs P` spreads the shards over P processes
of one Gloo group on the CPU instead (NCCL with a card per process).

    python -m cyclistsocialforce_tpu_torch.demos.demo_sharded \
        --agents 4096 --devices 8 --steps 40
"""

import argparse
import sys
import time

import torch

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of

# the receiver block: the kernels' smallest, so a shard of whole blocks
# runs on the card and on the CPU alike
BLOCK = 64


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--agents", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--devices", type=int, default=8,
                    help="the number of shards")
    ap.add_argument("--procs", type=int, default=1,
                    help="processes the shards are spread over (one "
                         "process group)")
    ap.add_argument("--comm", default="halo",
                    choices=["allgather", "ring", "halo"])
    ap.add_argument("--density", type=float, default=0.02)
    ap.add_argument("--skip-check", action="store_true",
                    help="skip the single-device equivalence check")
    ap.add_argument("--worker", nargs=2, default=None,
                    metavar=("RANK", "STORE"), help=argparse.SUPPRESS)
    add_device_argument(ap)
    return ap.parse_args(argv)


def run(args, device, group=None):
    from cyclistsocialforce_tpu_torch import Engine, NeighborConfig
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams
    from cyclistsocialforce_tpu_torch.parallel import (
        make_mesh, required_halo, shard_state, sharded_simulate_fn)
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    n_dev = args.devices
    lead = group is None or torch.distributed.get_rank() == 0
    n = (args.agents // (BLOCK * n_dev)) * BLOCK * n_dev  # whole blocks
    if n == 0:
        raise SystemExit(f"--agents must be at least {BLOCK * n_dev}")
    state = build_population(n, args.density, 16, None, torch.float64,
                             device)
    eng = Engine.create(
        BicycleParams.create(), MODELS["bicycle2d"], rep_force="twod",
        neighbors=NeighborConfig(cutoff=30.0, block=BLOCK, kb=64,
                                 rebuild_every=4))
    comm, kw = args.comm, {}
    if comm == "halo":
        h = required_halo(eng, state, n_dev) + 1
        strip_blocks = n // n_dev // BLOCK
        if h >= strip_blocks:
            # each strip spans too few cell columns for a boundary
            # exchange to make sense: the O(N) gather schedule instead
            if lead:
                print(f"halo window ({h} blocks) would cover a whole "
                      f"{strip_blocks}-block strip at this scale; using "
                      f"comm='allgather' (try --agents 16384+)")
            comm = "allgather"
        else:
            if lead:
                print(f"halo window: {h} source blocks/side of a "
                      f"{strip_blocks}-block strip (sized by "
                      f"parallel.required_halo)")
            kw = dict(halo=h)
    mesh = make_mesh(n_dev, group=group, device=device)
    if lead:
        print(f"{n} agents over {n_dev} shards on {device} "
              f"({mesh.world} process(es)), comm={comm}")
    shards = shard_state(state, mesh)
    t0 = time.perf_counter()
    final, extra = sharded_simulate_fn(eng, mesh, args.steps, record=False,
                                       comm=comm, **kw)(shards)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if comm == "halo":
        assert not bool(extra), "halo window overflowed -- grow halo"
    assert all(bool(torch.isfinite(f.s).all()) for f in final)
    if lead:
        print(f"sharded run: {args.steps} steps in {dt:.2f}s")

    if not args.skip_check:
        ref = eng.simulate(state, args.steps, record=False)[0]
        nl = n // n_dev
        err = max(float((f.s - ref.s[d * nl:(d + 1) * nl]).abs().max())
                  for d, f in zip(mesh.shards, final))
        pos_err = max(float((f.s[:, :2] - ref.s[d * nl:(d + 1) * nl, :2])
                            .abs().max())
                      for d, f in zip(mesh.shards, final))
        if lead:
            print(f"max |sharded - single-device| = {err:.3e}")
        if comm == "halo":
            # the same global sort, table and tile sums as the
            # single-device culled run
            assert err < 1e-9, err
            if lead:
                print("sharded run matches the single-device run "
                      "bit-exactly")
        else:
            # local sorts admit other fringe tiles than the single-device
            # partition: two culled approximations within the dropped
            # force's tail of each other
            assert pos_err < 0.05 * args.steps, pos_err
            if lead:
                print("sharded run tracks the single-device run within "
                      "the culled-truncation bound")
    if lead:
        print("demo_sharded: ok", flush=True)


def main(argv=None):
    args = parse(argv)
    device = device_of(args)
    if args.worker is not None:
        import torch.distributed as dist

        rank, store = int(args.worker[0]), args.worker[1]
        if device.type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.FileStore(store, args.procs), rank=rank,
            world_size=args.procs)
        try:
            run(args, device, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
        return
    if args.procs > 1:
        from cyclistsocialforce_tpu_torch.parallel.dryrun import run_workers

        if device.type == "cuda" and torch.cuda.device_count() < args.procs:
            raise SystemExit(f"{args.procs} NCCL processes need as many "
                             f"cards; run them on the CPU (--device cpu)")
        if args.devices % args.procs:
            raise SystemExit("--devices must divide by --procs")
        forward = sys.argv[1:] if argv is None else list(argv)
        run_workers(["cyclistsocialforce_tpu_torch.demos.demo_sharded",
                     *forward, "--worker"], args.procs)
        return
    run(args, device)


if __name__ == "__main__":
    main()
