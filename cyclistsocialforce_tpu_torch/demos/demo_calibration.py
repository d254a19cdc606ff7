"""Calibration demo: recover model parameters from observed trajectories.

Equivalent of the reference's calibration workflow (calibration.py +
controlbehavior.py): synthesize 'observed' tracks with known parameters,
then (1) recover them with Nelder-Mead over batched replays on the
device and (2) fit a GMM pole model to synthetic rider-behavior features
with cross-validated grid search. The test-track overlay it writes needs
matplotlib.

    python -m cyclistsocialforce_tpu_torch.demos.demo_calibration
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of


def synth_tracks(k_p_v, n_tracks=8, t_steps=200, seed=0, device="cuda"):
    from cyclistsocialforce_tpu_torch.calibration import CalibrationData
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import (BicycleParams,
                                                     as_population)
    from cyclistsocialforce_tpu_torch.state import make_state

    rng = np.random.default_rng(seed)
    model = MODELS["bicycle2d"]
    params = BicycleParams.create(k_p_v=k_p_v)
    s0 = np.zeros((n_tracks, 5))
    s0[:, 2] = rng.uniform(-0.4, 0.4, n_tracks)
    s0[:, 3] = rng.uniform(2.0, 5.0, n_tracks)
    t = np.arange(t_steps) * 0.01
    fx = 3.5 + np.sin(2 * np.pi * 0.25 * t)[None, :] \
        + rng.normal(0, 0.1, (n_tracks, 1))
    fy = np.sin(2 * np.pi * 0.2 * t + rng.uniform(0, np.pi,
                                                  (n_tracks, 1)))
    inputs = np.stack([fx * np.ones((n_tracks, t_steps)), fy], axis=2)

    pop = as_population(params, n_tracks, device)
    st = make_state(s0, dtype=torch.float64, device=device)
    u = torch.as_tensor(inputs, device=device)
    out = []
    for k in range(t_steps):
        st = model.step(pop, st, u[:, k, 0], u[:, k, 1])
        out.append(st.s[:, :2])
    out = torch.stack(out, dim=1).cpu().numpy()
    obs = np.concatenate([s0[:, None, :2], out[:, :-1]], axis=1)
    return CalibrationData.from_tracks(
        [(s0[j], inputs[j], obs[j]) for j in range(n_tracks)])


def main(argv=None):
    from cyclistsocialforce_tpu_torch import behavior
    from cyclistsocialforce_tpu_torch.calibration import Calibration
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    ap = argparse.ArgumentParser(description=__doc__)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    # ---- 1. trajectory calibration ----
    truth = 10.0
    data = synth_tracks(k_p_v=truth, device=device)
    train, test = data.split(0.75, rng=np.random.default_rng(1))
    cal = Calibration(MODELS["bicycle2d"], BicycleParams.create(),
                      ["k_p_v"], train, test_data=test,
                      objective_features=(0, 1), fix_speed=False,
                      maxiter=60, verbose=False, device=device)
    xopt, res = cal.run([4.0])
    print(f"calibration: true k_p_v={truth}, recovered {xopt[0]:.4f} "
          f"(train error {res['error']:.2e}, test {cal.test():.2e})")

    # result diagnostics (reference calibration.py:528-623): per-test-
    # track sim-vs-data overlay, written headlessly
    import matplotlib

    matplotlib.use("Agg")
    _, fig = cal.test(plot=True, name="calibrated")
    out_png = os.path.join(tempfile.gettempdir(),
                           "calibration_test_overlay.png")
    fig.savefig(out_png, dpi=110)
    print(f"test-track overlay written to {out_png}")

    # population sweep (one batched replay of the candidates)
    cands = np.linspace(6, 14, 9)[:, None]
    errs = cal.evaluate_population(cands)
    print("candidate sweep:",
          {f"{c[0]:.0f}": f"{e:.1e}" for c, e in zip(cands, errs)})

    # ---- 2. pole-model fitting ----
    rng = np.random.default_rng(7)
    n = 200
    v = rng.uniform(1.5, 5.5, n)
    X = np.stack([
        v,
        -8.0 - 0.8 * v + rng.normal(0, 0.4, n),
        -1.5 - 0.1 * v + rng.normal(0, 0.15, n),
        2.0 + 0.3 * v + np.abs(rng.normal(0, 0.2, n)),
        -3.0 - 0.2 * v + rng.normal(0, 0.2, n),
        6.0 + 0.5 * v + np.abs(rng.normal(0, 0.4, n))], axis=1)
    pm = behavior.fit_pole_model(X, "ImRe5GivenV", range_components=(1, 3),
                                 covariance_types=("full",), k_crossval=3,
                                 n_init=4, device=device)
    print("fitted pole model:", pm.gmm.n_components, "component(s); "
          "mean poles @3.5 m/s:", np.round(pm.mean_poles(3.5, 0), 2))


if __name__ == "__main__":
    main()
