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
~1,900); the stochastic balancing rider 2,740 (the balancing rider's 560
without its gains quintic, 505; the Ackermann basis M(v_mid), 30
quintics, ~304; the characteristic polynomial ~25 and K = c M ~50; the
resampling test and the selects ~15; and a draw, which the exact
resampling makes for every rider in every step and keeps where the
rider's speed passed the threshold, ~1,846: 8 uniforms ~32, 40 normals
~1,040 (~26 each: the uniform, w, one branch of Giles' polynomial), the
conditioning on the speed ~44, 8 rounds ~680 (~85 each: the component,
the triangular Cholesky product, the inverse preprocessing, the
stability test), the fallback ~37 and the pick of a round ~13). MUFU
work (sqrt, exp, log, pow, the trigonometry) and the threefry's integer
work are not counted."""

from benchmark.reference.step import reference_model
from benchmark.roofline import pair_forces

OPS_PER_RIDER = {"bicycle2d": 460, "balancingrider": 560, "twod": 1250,
                 "balancingrider_stochastic": 2740}


def fp32_ops(ctx):
    """float32 operations of the profiled steps, or None. A rider's are
    looked up by the configuration's reference model, which is its model
    unless it names another."""
    w = pair_forces.work(ctx)
    per_rider = OPS_PER_RIDER.get(reference_model(ctx["config"]))
    if w is None or per_rider is None:
        return None
    return w[0] + ctx["steps"] * ctx["n_active"] * per_rider
