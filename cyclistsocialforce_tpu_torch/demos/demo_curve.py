"""Curved-road demo: infrastructure forces.

Equivalent of the reference's scenarios/curve-scenario.py: a cyclist rides
a road with straight and curved segments whose edges exert repulsive
forces; optionally plots the road force field.

    python -m cyclistsocialforce_tpu_torch.demos.demo_curve --plot-field
"""

import argparse

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of


def main(argv=None):
    from cyclistsocialforce_tpu_torch import Engine, make_state
    from cyclistsocialforce_tpu_torch.models import MODELS, prepare
    from cyclistsocialforce_tpu_torch.params import (
        InvPendulumBicycleParams, RoadElementParams, as_population)
    from cyclistsocialforce_tpu_torch.road import (RoadSegmentCollection,
                                                   build_road_elements)
    from cyclistsocialforce_tpu_torch.scenario import Scenario
    from cyclistsocialforce_tpu_torch.state import set_destinations

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--t-end", type=float, default=20.0)
    ap.add_argument("--plot-field", action="store_true")
    ap.add_argument("--video", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    coll = RoadSegmentCollection.chain(
        (0.0, 0.0, 0.0),
        [("straight", 20.0), ("curve", 10.0, np.pi / 2, "left"),
         ("straight", 15.0)], width=4.0,
        params=RoadElementParams.create(F_0=0.5, sigma=2.5))
    road = build_road_elements([coll], device=device)
    dx, dy = coll.destinations()

    st = make_state(np.array([[1.0, 0.8, 0, 4, 0, 0, 0, 0]]),
                    dtype=torch.float64, device=device)
    st = set_destinations(st, 0, dx, dy)
    pop = as_population(InvPendulumBicycleParams.create(), 1, device)
    model = MODELS["twod"]
    st = prepare(model, pop, st)
    sc = Scenario(Engine.create(pop, model, road=road), st, chunk=50)

    if args.plot_field:
        import matplotlib.pyplot as plt

        from cyclistsocialforce_tpu_torch.viz import (draw_road,
                                                      plot_force_field)

        # reference-style field figure (scenarios/curve-scenario.py:90-125):
        # contourf of clamped |F| + white quiver + 1-D slice
        axes = plot_force_field((-5, 35), (-5, 35), road=road,
                                grid_step=0.25, quiver_step=1.0,
                                slice_y=0.0)
        ax0 = np.atleast_1d(axes)[0]
        draw_road(ax0, coll)
        ax0.set_title("road-edge force field")
        plt.show()
        return

    n_steps = int(args.t_end / sc.t_s)
    if args.video:
        from cyclistsocialforce_tpu_torch.viz import write_video
        write_video(sc, n_steps, args.video, xlim=(-5, 35), ylim=(-5, 35))
        print(f"wrote {args.video}")
    else:
        traj = sc.run(n_steps=n_steps, record=True)
        assert np.all(np.isfinite(traj)), "non-finite trajectories"
        print(sc.metrics.summary())
        print(f"final pos ({traj[-1, 0, 0]:.2f}, {traj[-1, 0, 1]:.2f})")


if __name__ == "__main__":
    main()
