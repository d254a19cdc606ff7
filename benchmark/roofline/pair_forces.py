"""The least the culled pair stage (the `pair_forces*` kernels: K1, K2,
K3) has to do in the profiled steps, whatever implements it.

The work is every ordered pair of active riders within the configuration's
cutoff, counted by the benchmark's own grid (`reference.grid`) from the
riders' positions at the profiled episode's chunk boundaries, each
chunk's pairs per step the mean of its two ends (the rebuilds inside a
chunk are not visible from outside `Engine.simulate`). Not the pairs the
neighbor table holds: a kernel that skips far tiles or pairs does less
work, not more.

Per pair (counted from the plain version, `ops/pair_forces.tile_forces`,
operation by operation): the twod field 67 float32 operations and the
field-of-view test 5, and 5 special-function (MUFU) operations. Bytes:
each row's source pack (16 floats) and receiver pack (8) read once and
its force (2) written once.
"""

from benchmark.peaks import FP32_FLOPS, HBM_BYTES_PER_S, MUFU_PER_S

OPS_FP32 = {"twod": 67 + 5}
OPS_MUFU = {"twod": 5}
FLOATS_PER_ROW = 16 + 8 + 2


def work(ctx):
    """(fp32 operations, MUFU operations, bytes) of the profiled steps, or
    None without a pair count."""
    pairs = ctx.get("pairs")
    field = ctx["config"].get("rep_force")
    if pairs is None or field not in OPS_FP32:
        return None
    return (pairs * OPS_FP32[field], pairs * OPS_MUFU[field],
            ctx["steps"] * ctx["rows"] * FLOATS_PER_ROW * 4)


def bound_seconds(ctx):
    """(least seconds, what bounds it) of the profiled steps' pair stage
    on one H100, or None."""
    w = work(ctx)
    if w is None:
        return None
    times = {"fp32": w[0] / FP32_FLOPS, "mufu": w[1] / MUFU_PER_S,
             "bytes": w[2] / HBM_BYTES_PER_S}
    which = max(times, key=times.get)
    return times[which], which
