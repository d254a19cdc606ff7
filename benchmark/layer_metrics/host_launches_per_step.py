"""Host calls that start device work (cudaLaunchKernel, cudaMemcpyAsync,
cudaMemsetAsync, cudaGraphLaunch) per step."""

UNIT = "launches/step"
LAYER = "step loop"
MOVES = "agent_steps_per_s"


def read(ctx):
    return sum(ctx["host_calls"].values()) / ctx["steps"]
