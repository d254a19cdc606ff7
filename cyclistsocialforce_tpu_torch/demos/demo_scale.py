"""Scale demo: 100k cyclists on one card.

A 100,000-agent population advancing through the full social-force
pipeline (destination forces + navigation FSM, block-sparse culled
pairwise repulsion through the pair kernel, bicycle dynamics), each
20-step chunk of `Engine.simulate` one CUDA-graph replay on the card.

    python -m cyclistsocialforce_tpu_torch.demos.demo_scale \
        --agents 100000 --steps 100

`--backend` takes the JAX demo's names and the port's kernels: "pallas"
is K1, "pallas_unrolled" K2, "pallas_db" K3; "xla" and "interpret" name
JAX's plain versions of the pair sum, which the port runs on CPU tensors
(every kernel backend runs its plain version there), so they take
`--device cpu`.
"""

import argparse
import time

import torch

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of

PLAIN_BACKENDS = ("xla", "interpret")


def main(argv=None):
    from cyclistsocialforce_tpu_torch import Engine, NeighborConfig
    from cyclistsocialforce_tpu_torch.models import MODELS, prepare
    from cyclistsocialforce_tpu_torch.params import (
        BalancingRiderParams, BicycleParams, InvPendulumBicycleParams)
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--agents", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--density", type=float, default=0.02,
                    help="agents/m^2 (0.02 = heavy bike traffic)")
    ap.add_argument("--dense", action="store_true",
                    help="dense O(N^2) instead of neighbor culling")
    ap.add_argument("--backend", default="pallas",
                    choices=["pallas", "pallas_unrolled", "pallas_db",
                             *PLAIN_BACKENDS])
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="write a crowd density heatmap of the final "
                         "state (viz.plot_density; occupancy + mean "
                         "speed panels)")
    ap.add_argument("--model", default="bicycle2d",
                    choices=["bicycle2d", "twod", "invpendulum",
                             "balancingrider"],
                    help="dynamics model")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    backend = args.backend
    if backend in PLAIN_BACKENDS:
        if device.type != "cpu":
            raise SystemExit(f"--backend {backend} is the pair sum's plain "
                             f"version, which runs on CPU tensors: pass "
                             f"--device cpu, or a kernel backend")
        backend = "pallas"           # its plain version on CPU tensors

    # the bench configuration: fine-y serpentine-sorted block=128 tables,
    # capacity kb=13, 50 m cutoff (dropped force < 1e-4), no screen
    spline = args.model in ("twod", "invpendulum")
    state = build_population(args.agents, args.density,
                             128 if spline else 8,
                             None if args.dense else 128, torch.float32,
                             device, model=args.model)
    nb = None if args.dense else NeighborConfig(
        cutoff=50.0, block=128, kb=13, backend=backend, rebuild_every=20,
        screen=False)
    if args.model == "balancingrider":
        params = BalancingRiderParams.create(gains_lut=4096, verbose=False)
    elif args.model == "invpendulum":
        params = InvPendulumBicycleParams.create(zoh_lut=4096)
    else:
        params = BicycleParams.create()
    model = MODELS[args.model]
    eng = Engine.create(
        params, model,
        rep_force="twod" if args.model == "bicycle2d" else None,
        neighbors=nb, rep_chunk=1000 if args.dense else None)
    state = prepare(model, params, state)

    def run():
        out = eng.simulate(state, args.steps, record=False)[0]
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        return out

    run()                                      # builds, captures
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    assert bool(torch.isfinite(out.s).all()), "non-finite state"
    asps = args.agents * args.steps / dt
    print(f"{args.agents} agents x {args.steps} steps in {dt:.3f} s")
    print(f"= {asps:,.0f} agent-steps/sec "
          f"({asps / (100 * args.agents):.2f}x real time)")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from cyclistsocialforce_tpu_torch.viz import plot_density

        fig, axes = plt.subplots(1, 2, figsize=(13, 5.5),
                                 layout="constrained")
        plot_density(out, bins=512, ax=axes[0])
        axes[0].set_title(f"occupancy after {args.steps} steps "
                          f"(N={args.agents:,})")
        plot_density(out, bins=512, quantity="speed", ax=axes[1])
        axes[1].set_title("mean speed [m/s]")
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"density heatmap -> {args.plot}")


if __name__ == "__main__":
    main()
