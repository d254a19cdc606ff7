"""Pole-model verification plot.

Equivalent of the reference's tests/test_balancingrider_polemodels.py:
plots the mean pole locations of each GMM component against speed, plus a
cloud of stochastic pole samples, for visual comparison with Fig. 18 of
the BalancingRider paper. It draws, so it needs matplotlib.

    python -m cyclistsocialforce_tpu_torch.demos.demo_polemodel \\
        --model BR1 --out poles.png
"""

import argparse

import numpy as np

from cyclistsocialforce_tpu_torch.demos import add_device_argument, device_of


def main(argv=None):
    from cyclistsocialforce_tpu_torch.behavior import load_packaged_polemodel

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="BR1", choices=["BR0", "BR1", "PP0"])
    ap.add_argument("--out", default=None,
                    help="save to file instead of showing")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    # the pole model's means and samples are host numpy; the device is
    # checked all the same, as every demo does
    device_of(args)

    import matplotlib
    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    name = {"BR0": "BR0_ImRe5GivenV_pole-model-params.yaml",
            "BR1": "BR1_ImRe5GivenV_pole-model-params.yaml",
            "PP0": "PP0_Re1GivenV_pole-model-params.yaml"}[args.model]
    pm = load_packaged_polemodel(name)

    fig, ax = plt.subplots(figsize=(7, 6))
    speeds = np.linspace(1.5, 5.5, 40)
    cmap = plt.cm.viridis

    for comp in range(pm.gmm.n_components):
        marker = ["o", "s", "^"][comp % 3]
        for i, v in enumerate(speeds):
            poles = pm.mean_poles(v, component=comp)
            ax.scatter(poles.real, poles.imag, s=18, marker=marker,
                       color=cmap(i / len(speeds)),
                       label=(f"component {comp}" if i == 0 else None))

    rng = np.random.default_rng(0)
    samples, _ = pm.sample_poles(150, X_given=3.5, rng=rng)
    ax.scatter(samples.real, samples.imag, s=6, color="gray", alpha=0.4,
               label="samples @ v=3.5 m/s")

    ax.axvline(0, color="red", linewidth=0.8)
    ax.set_xlabel(r"Re(s) [1/s]")
    ax.set_ylabel(r"Im(s) [1/s]")
    ax.set_title(f"{args.model} pole model: component means over speed "
                 f"(color = 1.5...5.5 m/s)")
    ax.legend()
    if args.out:
        fig.savefig(args.out, dpi=120)
        print(f"wrote {args.out}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
