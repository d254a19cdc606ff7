"""Stream time of the neighbor-table rebuilds (the port's `csf::rebuild`
spans: sort, gathers, box distances, top-k) per step."""

from benchmark.spans import stream_ms_per_step

UNIT = "ms"
LAYER = "table rebuild"
MOVES = "agent_steps_per_s"


def read(ctx):
    return stream_ms_per_step(ctx, ("rebuild",))
