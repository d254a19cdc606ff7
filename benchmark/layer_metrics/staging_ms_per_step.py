"""Stream time of the step loop's staging copies per step: the state
into the table's cell order and back (`csf::permute`, `csf::unpermute`),
the copies into the chunk graph's static buffers (`csf::load`) and out
of them (`csf::copy_out`)."""

from benchmark.spans import stream_ms_per_step

UNIT = "ms"
LAYER = "step loop"
MOVES = "agent_steps_per_s"


def read(ctx):
    return stream_ms_per_step(ctx, ("permute", "load", "copy_out",
                                    "unpermute"))
