"""The host's time to issue a chunk per step: the host time of the
port's `csf::simulate` spans (each `Engine.simulate` call, from its entry
to its return, which waits on nothing) over the steps."""

from benchmark.spans import PREFIX, report

UNIT = "ms"
LAYER = "step loop"
MOVES = "agent_steps_per_s"


def read(ctx):
    rep = report(ctx)
    span = rep and rep["spans"].get(PREFIX + "simulate")
    return None if not span else span["host_ms"] / rep["steps"]
