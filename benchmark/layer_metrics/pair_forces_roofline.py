"""The pair kernels' share of their roofline: the least time the pairs
within the cutoff need on one H100 (`roofline.pair_forces`) over the
kernels' measured device time, in percent."""

from benchmark.roofline import pair_forces
from benchmark.trace import kernel_us

UNIT = "%"
LAYER = "culled pair stage"
MOVES = "agent_steps_per_s"


def read(ctx):
    us = kernel_us(ctx, "pair_forces")
    bound = pair_forces.bound_seconds(ctx)
    if not us or bound is None:
        return None
    return 100.0 * bound[0] / (1e-6 * us)
