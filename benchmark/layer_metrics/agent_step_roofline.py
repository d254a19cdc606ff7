"""The per-agent kernels' share of their roofline: the bytes they need
over the H100's bandwidth (`roofline.agent_step`) against their measured
device time, in percent."""

from benchmark.roofline import agent_step
from benchmark.trace import kernel_us

UNIT = "%"
LAYER = "per-agent kernels"
MOVES = "agent_steps_per_s"


def read(ctx):
    us = kernel_us(ctx, "agent_pre_kernel") + kernel_us(ctx,
                                                        "agent_post_kernel")
    return None if not us else (100.0 * agent_step.bound_seconds(ctx)
                                / (1e-6 * us))
