"""Standalone demo: the 3-cyclist encroachment scenario.

Equivalent of the reference's demo/demoCSFstandalone.py: three cyclists
on colliding paths negotiate a shared space via social forces, with a
selectable dynamics model. Runs headless by default; `--animate` opens a
matplotlib animation, `--video out.mp4` writes a video.

    python -m cyclistsocialforce_tpu_torch.demos.demo_standalone \\
        --model balancingrider --animate
"""

import argparse

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of


def build(model_name, device):
    from cyclistsocialforce_tpu_torch import Engine, make_state
    from cyclistsocialforce_tpu_torch.models import MODELS, prepare
    from cyclistsocialforce_tpu_torch.params import (
        BalancingRiderParams, BicycleParams, HessBikeRiderParams,
        InvPendulumBicycleParams, PlanarBicycleParams,
        PlanarPointBicycleParams, as_population)
    from cyclistsocialforce_tpu_torch.scenario import Scenario
    from cyclistsocialforce_tpu_torch.state import set_destinations

    params = {
        "bicycle2d": BicycleParams,
        "twod": InvPendulumBicycleParams,
        "invpendulum": InvPendulumBicycleParams,
        "balancingrider": BalancingRiderParams,
        "planarpoint": PlanarPointBicycleParams,
        "planarbicycle": PlanarBicycleParams,
        "hess": HessBikeRiderParams,
    }[model_name].create()

    s0 = np.array([
        [-6.0, 0, 0, 5, 0, 0, 0, 0],
        [15.0, -20, np.pi / 2, 5, 0, 0, 0, 0],
        [13.0, -20, np.pi / 2, 5, 0, 0, 0, 0],
    ])
    st = make_state(s0, dtype=torch.float64, device=device)
    st = set_destinations(st, 0, (35, 64, 65), (0, 0, 0))
    st = set_destinations(st, 1, (15, 15, 15), (20, 49, 50))
    st = set_destinations(st, 2, (13, 13, 13), (20, 49, 50))
    pop = as_population(params, 3, device).replace(
        v_desired_default=torch.tensor([4.5, 5.0, 5.0], dtype=torch.float64,
                                       device=device))
    model = MODELS[model_name]
    st = prepare(model, pop, st)
    return Scenario(Engine.create(pop, model), st, chunk=10)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="twod",
                    choices=["bicycle2d", "twod", "invpendulum",
                             "balancingrider", "planarpoint",
                             "planarbicycle", "hess"])
    ap.add_argument("--t-end", type=float, default=10.0)
    ap.add_argument("--animate", action="store_true")
    ap.add_argument("--video", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    sc = build(args.model, device_of(args))
    n_steps = int(args.t_end / sc.t_s)

    if args.video:
        from cyclistsocialforce_tpu_torch.viz import write_video
        write_video(sc, n_steps, args.video, xlim=(-10, 40),
                    ylim=(-25, 25))
        print(f"wrote {args.video}")
    elif args.animate:
        import matplotlib.pyplot as plt

        from cyclistsocialforce_tpu_torch.viz import animate
        sc.run_time_factor = 1.0
        anim = animate(sc, n_steps, xlim=(-10, 40), ylim=(-25, 25))  # noqa: F841
        plt.show()
    else:
        traj = sc.run(n_steps=n_steps, record=True)
        assert np.all(np.isfinite(traj)), "non-finite trajectories"
        print(f"model={args.model}: {sc.metrics.summary()}")
        for a in range(3):
            print(f"  agent {a}: final pos "
                  f"({traj[-1, a, 0]:.2f}, {traj[-1, a, 1]:.2f}), "
                  f"v={traj[-1, a, 3]:.2f} m/s")


if __name__ == "__main__":
    main()
