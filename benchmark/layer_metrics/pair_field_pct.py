"""The share of the pairs the neighbor tables hand the pair kernel whose
field K1 evaluated, over the profiled steps: the port's `field_pairs`
counter (in K1's FOV forms, the pairs of the units of one receiver and a
run of source rows in which some pair needs the field; in its other
forms every pair) over its `table_pairs` counter (each table's valid
slots x block x block_src x the steps it serves), in percent. None where
the program has no `field_pairs` counter (a checkout from before it)."""

from benchmark.spans import report

UNIT = "%"
LAYER = "culled pair stage"
MOVES = "agent_steps_per_s"


def read(ctx):
    rep = report(ctx)
    if rep is None:
        return None
    walked = rep["counters"].get("table_pairs")
    field = rep["counters"].get("field_pairs")
    if not walked or field is None:
        return None
    return 100.0 * field / walked
