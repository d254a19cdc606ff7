"""Device time of the per-agent kernels (agent_pre, agent_post) per
step."""

from benchmark.trace import kernel_us

UNIT = "ms"
LAYER = "per-agent kernels"
MOVES = "agent_steps_per_s"


def read(ctx):
    us = kernel_us(ctx, "agent_pre_kernel") + kernel_us(ctx,
                                                        "agent_post_kernel")
    return None if not us else 1e-3 * us / ctx["steps"]
