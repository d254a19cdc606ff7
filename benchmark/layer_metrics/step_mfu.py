"""The whole step's share of the H100's float32 peak: the operations the
profiled steps need (`roofline.step`) over the profiled sub-window's
length times 67 TFLOP/s, in percent."""

from benchmark.peaks import FP32_FLOPS
from benchmark.roofline import step

UNIT = "%"
LAYER = "whole step"
MOVES = "agent_steps_per_s"


def read(ctx):
    ops = step.fp32_ops(ctx)
    if ops is None:
        return None
    return 100.0 * ops / (1e-6 * ctx["window_us"] * FP32_FLOPS)
