"""Device time of the pair kernels (`pair_forces*`) per step."""

from benchmark.trace import kernel_us

UNIT = "ms"
LAYER = "culled pair stage"
MOVES = "agent_steps_per_s"


def read(ctx):
    us = kernel_us(ctx, "pair_forces")
    return None if not us else 1e-3 * us / ctx["steps"]
