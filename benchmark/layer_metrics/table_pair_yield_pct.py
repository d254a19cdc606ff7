"""The share of the pairs the neighbor tables hand the pair kernel that
the inputs need: the pairs within the cutoff over the profiled steps (the
benchmark's own grid count) over the port's `table_pairs` counter (each
table's valid slots x block x block_src x the steps it serves), in
percent."""

from benchmark.spans import report

UNIT = "%"
LAYER = "culled pair stage"
MOVES = "agent_steps_per_s"


def read(ctx):
    rep = report(ctx)
    walked = rep and rep["counters"].get("table_pairs")
    if not walked or ctx.get("pairs") is None:
        return None
    return 100.0 * ctx["pairs"] / walked
