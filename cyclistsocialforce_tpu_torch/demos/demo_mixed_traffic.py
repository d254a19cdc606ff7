"""Mixed-traffic demo: heterogeneous crowd + scripted cars, culled.

A corridor of cyclists from TWO model families (legacy bicycle2d and
BMD2023 twod riders) shares the road with scripted cars that replay
prescribed trajectories, ignore social forces, but emit their repulsive
field into the crowd -- the reference's daily heterogeneous use case
(intersection.py:813-823 double dispatch + vehicle.py:920-987
UncontrolledVehicle), here through the culled pair kernel's mixed-family
form (K1) at thousands of agents.

    python -m cyclistsocialforce_tpu_torch.demos.demo_mixed_traffic \
        --riders 2000 --cars 8 --steps 300
    python -m cyclistsocialforce_tpu_torch.demos.demo_mixed_traffic \
        --plot out.png
"""

import argparse

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of


def build(n_riders, n_cars, steps, t_s=0.01, device="cuda"):
    from cyclistsocialforce_tpu_torch import NeighborConfig, make_state
    from cyclistsocialforce_tpu_torch.engine import ScriptedTraj
    from cyclistsocialforce_tpu_torch.mixed import (MixedEngine,
                                                    prepare_groups)
    from cyclistsocialforce_tpu_torch.params import (
        BicycleParams, InvPendulumBicycleParams, as_population)

    rng = np.random.default_rng(0)
    n = n_cars + n_riders
    n_legacy = n_riders // 2
    n_twod = n_riders - n_legacy

    # corridor: riders ride +x on y in [0, 60], cars drive +x on the
    # central lane y in [28, 32] at car speed
    s0 = np.zeros((n, 5))
    # cars first (one contiguous scripted group)
    corridor = n_riders / (60 * 0.02)
    s0[:n_cars, 0] = rng.uniform(0, corridor, n_cars)
    s0[:n_cars, 1] = rng.uniform(29, 31, n_cars)
    s0[:n_cars, 3] = 12.0
    s0[n_cars:, 0] = rng.uniform(0, corridor, n_riders)
    s0[n_cars:, 1] = rng.uniform(0, 60, n_riders)
    s0[n_cars:, 2] = rng.uniform(-0.2, 0.2, n_riders)
    s0[n_cars:, 3] = rng.uniform(3, 6, n_riders)

    st = make_state(s0, dtype=torch.float64, device=device)
    dst = np.zeros((n, 3))
    dst[:, 0] = s0[:, 0] + 500.0
    dst[:, 1] = s0[:, 1]
    dst = torch.as_tensor(dst, device=device)
    dq = st.destqueue.clone()
    dq[:, 0, :] = dst
    st = st.replace(dest=dst, destqueue=dq)

    # scripted car trajectories: straight +x at constant speed
    trajs = {}
    ts_grid = t_s * np.arange(steps + 1)
    for c in range(n_cars):
        tr = np.zeros((steps + 1, 4))
        tr[:, 0] = s0[c, 0] + 12.0 * ts_grid
        tr[:, 1] = s0[c, 1]
        tr[:, 3] = 12.0
        trajs[c] = tr
    scripted = ScriptedTraj.create(n, trajs, torch.float64, device)

    # cars emit a STRONG wide twod field (car-sized f_0/sigma)
    p_car = as_population(InvPendulumBicycleParams.create(
        f_0=40.0, sigma_0=4.0, sigma_1=8.0, sigma_2=2.0,
        sigma_3=6.0), n_cars, device)
    p_legacy = as_population(BicycleParams.create(), n_legacy, device)
    p_twod = as_population(InvPendulumBicycleParams.create(), n_twod,
                           device)
    eng = MixedEngine.create(
        [("twod", p_car, n_cars), ("bicycle2d", p_legacy, n_legacy),
         ("twod", p_twod, n_twod)],
        scripted=scripted,
        neighbors=NeighborConfig(cutoff=50.0, block=128, kb=24,
                                 rebuild_every=10, screen=False))
    st = prepare_groups(eng, st)
    return eng, st


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--riders", type=int, default=2000)
    ap.add_argument("--cars", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--plot", default=None, help="write a PNG overview")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    eng, st = build(args.riders, args.cars, args.steps,
                    device=device_of(args))
    final, traj = eng.simulate(st, args.steps)
    traj = traj.cpu().numpy()
    assert np.all(np.isfinite(traj)), "non-finite trajectories"

    # rider lateral displacement near the car lane shows the interaction
    y0 = st.s[args.cars:, 1].cpu().numpy()
    yT = traj[-1, args.cars:, 1]
    near = np.abs(y0 - 30.0) < 4.0
    print(f"{args.riders} riders (2 families) + {args.cars} scripted cars, "
          f"{args.steps} steps")
    shift = np.abs(yT - y0)
    print(f"lateral shift near the car lane: mean {shift[near].mean():.2f} "
          f"/ max {shift[near].max():.2f} m (elsewhere mean "
          f"{shift[~near].mean():.2f} m)")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(12, 4))
        for a in range(args.cars, min(args.cars + 400, traj.shape[1])):
            ax.plot(traj[:, a, 0], traj[:, a, 1], lw=0.4, alpha=0.4,
                    color="C0")
        for c in range(args.cars):
            ax.plot(traj[:, c, 0], traj[:, c, 1], lw=2.0, color="C3")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_title("mixed traffic: riders (blue) yield to scripted "
                     "cars (red)")
        fig.savefig(args.plot, dpi=110, bbox_inches="tight")
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
