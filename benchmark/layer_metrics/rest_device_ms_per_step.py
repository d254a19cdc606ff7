"""Device busy time per step that is neither the pair kernels nor the
per-agent kernels: the torch chain of per-agent operations, the table
rebuilds, the permutations and the copies."""

from benchmark.trace import kernel_us

UNIT = "ms"
LAYER = "per-agent torch chain, table rebuild and copies"
MOVES = "agent_steps_per_s"


def read(ctx):
    rest = (ctx["busy_us"] - kernel_us(ctx, "pair_forces")
            - kernel_us(ctx, "agent_pre_kernel")
            - kernel_us(ctx, "agent_post_kernel"))
    return 1e-3 * rest / ctx["steps"]
