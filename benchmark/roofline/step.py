"""The float32 operations one whole step needs, for `step_mfu`: the pair
stage's (`roofline.pair_forces`) and each active rider's own. Per rider,
counted from the plain code, operation by operation and rounded down:
bicycle2d 460 (agent_pre 160 and agent_post 300, the count of
`chip_smoke.OPS_AGENT`); the balancing rider 560 (destination force, FSM
and clamp ~100; the gains quintic ~55; A(v) and A - B K ~150; the
midpoint right-hand side ~65; I - h/2 A ~30; the 5 x 5 solve ~110; the
positions and the frame flip ~50); twod 1,250 (bicycle2d's 460 with its
first pass of the queue update and the FSM; the second pass and the
straight line ~100; the not-a-knot fit through 6 points, chords,
system and banded solve with 2 right-hand sides ~140; 20 samples of the
spline and their distances to the rider ~500, ~25 a sample after ~40 a
interval; the derivatives at the rider's sample, the curvature, the
speed limit and the force ~45: the least the spline needs, where the
plain reference's dense form, derivatives at every sample, takes
~1,900). MUFU work is not counted."""

from benchmark.roofline import pair_forces

OPS_PER_RIDER = {"bicycle2d": 460, "balancingrider": 560, "twod": 1250}


def fp32_ops(ctx):
    """float32 operations of the profiled steps, or None."""
    w = pair_forces.work(ctx)
    per_rider = OPS_PER_RIDER.get(ctx["config"]["model"])
    if w is None or per_rider is None:
        return None
    return w[0] + ctx["steps"] * ctx["n_active"] * per_rider
