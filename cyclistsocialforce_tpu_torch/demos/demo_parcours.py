"""Parcours demo: destination-queue following.

Equivalent of the reference's scenarios/parcours-scenario.py: one cyclist
follows a slalom of queued destinations under the spline path-planning
destination force (curvature-limited desired speed).

    python -m cyclistsocialforce_tpu_torch.demos.demo_parcours \\
        --model twod --video parcours.mp4
"""

import argparse

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of


def main(argv=None):
    from cyclistsocialforce_tpu_torch import Engine, make_state
    from cyclistsocialforce_tpu_torch.models import MODELS, prepare
    from cyclistsocialforce_tpu_torch.params import (
        InvPendulumBicycleParams, PlanarPointBicycleParams, as_population)
    from cyclistsocialforce_tpu_torch.scenario import Scenario
    from cyclistsocialforce_tpu_torch.state import set_destinations

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="twod",
                    choices=["twod", "planarpoint", "invpendulum"])
    ap.add_argument("--t-end", type=float, default=25.0)
    ap.add_argument("--video", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    params_cls = (PlanarPointBicycleParams if args.model == "planarpoint"
                  else InvPendulumBicycleParams)
    params = params_cls.create()
    st = make_state(np.array([[0.0, 0, 0, 5, 0, 0, 0, 0]]),
                    dtype=torch.float64, device=device)
    st = set_destinations(st, 0, (10, 20, 30, 40, 50, 50, 50),
                          (0, 4, -4, 0, 4, 30, 31))
    pop = as_population(params, 1, device)
    model = MODELS[args.model]
    st = prepare(model, pop, st)
    sc = Scenario(Engine.create(pop, model), st, chunk=50)

    n_steps = int(args.t_end / sc.t_s)
    if args.video:
        from cyclistsocialforce_tpu_torch.viz import write_video
        write_video(sc, n_steps, args.video, xlim=(-5, 55),
                    ylim=(-10, 35))
        print(f"wrote {args.video}")
    else:
        traj = sc.run(n_steps=n_steps, record=True)
        assert np.all(np.isfinite(traj)), "non-finite trajectories"
        print(sc.metrics.summary())
        print("waypoints reached, final pos "
              f"({traj[-1, 0, 0]:.2f}, {traj[-1, 0, 1]:.2f})")


if __name__ == "__main__":
    main()
